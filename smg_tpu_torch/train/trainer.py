"""The multistage trainer: batched scoring, DQN labels, the update
(port of smg_tpu/train/trainer.py).

- `score_scene_batch`: the online net's eval scores (trainer.py:282-384)
  at ModelConfig.num_rotations R rotations of the scene stream (rotation
  0 the unrotated image), including the ETS pair branch, which stays at
  rotation 0. `scene_chunk` bounds memory only: every scoring unit of a
  chunk of scenes goes into one trunk call per style, the R rotated scene
  images beside the masks, each mask once (eval BatchNorm makes the
  per-image math that of the JAX package's batch-1 units).
- `dqn_labels` (trainer.py:411-474): r + gamma Q_target(s', a*_online) with
  the future term zeroed on failure and on a cleared table; the target net
  scores (scene, exec mask) pairs grouped by style (`_eval_styled`), the
  scene stream rotated by the exploit action's rotation index (for ETS
  the grasp member's, trainer.py:449-456, though ETS scores at rotation
  0).
- `reactive_labels` (trainer.py:390-400).
- `update` (trainer.py:640-761), unrotated at any R as in the JAX
  package (trainer.py:659-669): each scene's scene and mask streams are
  separate train-mode passes with their own BatchNorm statistics; the
  scenes of one style go through one trunk call with per-image moments
  (the JAX package's style-grouped and all-styles-then-select forms are
  pinned equal, tests/test_train.py::TestChunkedDispatch). Loss summed over
  valid scenes / max(n_valid, 1); Adam; the running statistics of the
  executed style's trunk and head take each scene's update and are then
  averaged over all B scenes, invalid ones included. The ETS style's head
  is `AffordanceNet.head(2)`: the suction head while tied_ets_head, else
  gs_head, which then takes style 2's gradient and statistics
  (trainer.py:256-277).

With ModelConfig.trunk = "tiny", eval scoring goes through the module
forward (AffordanceNet.score; TrainConfig.fast_eval "auto", or "off" for
any trunk) and the update through fast_trunk's tiny
train forward, as the JAX trainer's fast paths are DenseNet-only
(trainer.py:230-253, :505-530); the eval backends and fast_train_conv2
"pk" raise for it.

The Trainer owns the online net, the target net (a copy whose BatchNorm
buffers freeze between syncs) and torch.optim.Adam; TrainerState carries
the iteration. `Trainer.reducer` is None except under data parallelism
over more than one rank, where parallel/sharded.py sets it: the update
then sums the valid count, the gradients and the running statistics over
the ranks, so that it computes the one-process update of the whole batch. Master weights are f32; the trunks compute in the model's
dtype (bf16 in production).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from smg_tpu_torch.models import affordance as aff
from smg_tpu_torch.models.affordance import (
    STYLE_ETS,
    STYLE_GRASP,
    STYLE_SUCTION,
    AffordanceNet,
    ModelConfig,
)
from smg_tpu_torch.physics.state import N_SLOTS, _Batched
from smg_tpu_torch.policy.arbitrate import ACTION_GRASP, ACTION_SUCTION
from smg_tpu_torch.train import losses
from smg_tpu_torch.utils import profiling

_PI, _PJ = np.triu_indices(N_SLOTS, k=1)
N_PAIRS = int(_PI.shape[0])


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    method: str = "reinforcement"
    future_reward_discount: float = 0.5  # gamma (main.py:442)
    learning_rate: float = 1e-4          # Adam (trainer.py:99)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    target_update_freq: int = 10         # main.py:450
    is_ets: bool = False
    scene_chunk: int = 4
    # The eval forward of scoring and labels (trainer.py:64-69, :505-515):
    # "on" the fast trunk (fast_trunk.score_eval over the kernels), "off"
    # the module forward (AffordanceNet.score), "auto" the fast trunk for
    # DenseNet-121 and the module forward for the tiny trunk. JAX resolves
    # "auto" to the module forward off the TPU as well; the port runs the
    # kernels' plain versions on the CPU.
    fast_eval: str = "auto"
    # The update's dense layers: 'conv' is autograd of the conv form (the
    # JAX default); 'pk' runs the K6 kernels forward and backward.
    fast_train_conv2: str = "conv"


@dataclass
class TrainerState:
    """What the loop carries of the trainer: the global iteration. The
    online and target nets and the optimizer live in the Trainer."""

    iteration: int = 0


@dataclass
class Experience(_Batched):
    scene_depth: torch.Tensor   # (B, 224, 224)
    exec_mask: torch.Tensor     # (B, 224, 224) bool
    style: torch.Tensor         # (B,) int32
    valid: torch.Tensor         # (B,) bool


@dataclass
class SceneScores(_Batched):
    gra_conf: torch.Tensor   # (B, N, R): R = ModelConfig.num_rotations
    suc_conf: torch.Tensor   # (B, N, R)
    gs_conf: torch.Tensor    # (B, N, N)


class Trainer:
    """Owns the online and target AffordanceNets and Adam on `device`
    (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: TrainConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = AffordanceNet(cfg.model).to(self.device).eval()
        self.target = copy.deepcopy(self.model).requires_grad_(False)
        self.opt = self.new_optimizer()
        self.reducer = None   # parallel/sharded.py's Reducer, over > 1 rank
        self._useful_by_n = None   # useful trunk images by valid objects, made when counted

    def new_optimizer(self) -> torch.optim.Adam:
        """optax.adam's update: lr * m_hat / (sqrt(v_hat) + eps), no decay."""
        cfg = self.cfg
        return torch.optim.Adam(self.model.parameters(), lr=cfg.learning_rate,
                                betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
                                weight_decay=0.0)

    def init_state(self, generator: torch.Generator) -> TrainerState:
        """Seeded init of the online net (Flax's default, aff.init_params), the target as its
        copy, a fresh optimizer."""
        aff.init_params(self.model, generator)
        self.target.load_state_dict(self.model.state_dict())
        self.opt = self.new_optimizer()
        return TrainerState(iteration=0)

    def maybe_sync_target(self, state: TrainerState) -> None:
        """Copy online -> target, BatchNorm statistics included, every
        target_update_freq iterations (trainer.py:150-162)."""
        if state.iteration % self.cfg.target_update_freq == 0:
            self.target.load_state_dict(self.model.state_dict())

    def _prep(self, depth):
        return aff.preprocess_depth(depth, self.cfg.model)

    @property
    def use_fast_eval(self) -> bool:
        """TrainConfig.fast_eval resolved (trainer.py:505-515)."""
        if self.cfg.fast_eval not in ("on", "off", "auto"):
            raise ValueError(f"fast_eval must be 'on', 'off' or 'auto', "
                             f"got {self.cfg.fast_eval!r}")
        if self.cfg.fast_eval == "auto":
            return self.cfg.model.trunk == "densenet121"
        return self.cfg.fast_eval == "on"

    def _score_eval(self, net: AffordanceNet, scene_img, mask_imgs, style: int):
        """Eval scores (B, M, num_out): the kernels' path (score_eval) or the
        module forward (score), as TrainConfig.fast_eval resolves."""
        with profiling.span("score_eval", style=style):
            if profiling.enabled():
                profiling.count("trunk_images", math.prod(scene_img.shape[:-3])
                                + mask_imgs.shape[0] * mask_imgs.shape[1])
            if self.use_fast_eval:
                return net.score_eval(scene_img, mask_imgs, style)
            return net.score(scene_img, mask_imgs, style)

    def _postprocess(self, out: torch.Tensor) -> torch.Tensor:
        """(..., num_out) -> (..., 1): P(class 0) for reactive, raw Q
        for reinforcement (trainer.py:360-368)."""
        if self.cfg.method == "reactive":
            return torch.softmax(out, dim=-1)[..., :1]
        return out

    def _rotated_scenes(self, scene_img: torch.Tensor) -> torch.Tensor:
        """(C, S, S, 3) -> (C, R, S, S, 3): rotation r turns each scene by
        r 2 pi / R, its angle rounded once to float32 (trainer.py:305-310);
        rotation 0 is the image itself."""
        R = self.cfg.model.num_rotations
        if R == 1:
            return scene_img[:, None]
        theta = torch.tensor([r * (2.0 * math.pi / R) for r in range(R)],
                             dtype=torch.float32, device=scene_img.device)
        return aff.rotate_image_nearest(
            scene_img[:, None].expand((-1, R) + scene_img.shape[1:]), theta)

    def score_scene(self, scene_depth, masks, valid) -> SceneScores:
        """Score scenes: (C, 224, 224) masked depth, (C, N, 224, 224)
        masks, (C, N) valid (trainer.py:282-358): grasp and suction at
        each of the R rotations, ETS pairs at rotation 0 (:325)."""
        with profiling.span("score_scene"):
            if profiling.enabled():
                self._count_useful(valid)
            cfg = self.cfg
            model = self.model
            C = scene_depth.shape[0]
            scene_img = self._prep(scene_depth)                     # (C, S, S, 3)
            scene_rot = self._rotated_scenes(scene_img)             # (C, R, S, S, 3)
            obj_ins = self._prep(scene_depth[:, None] * masks)      # (C, N, S, S, 3)
            gra_conf, suc_conf = (
                self._postprocess(self._score_eval(model, scene_rot, obj_ins, s))[..., 0]
                for s in (STYLE_GRASP, STYLE_SUCTION))              # (C, N, R)
            gs_conf = torch.full((C, N_SLOTS, N_SLOTS), -100.0,
                                 device=scene_depth.device)
            if cfg.is_ets:
                pi = torch.as_tensor(_PI, device=masks.device)
                pj = torch.as_tensor(_PJ, device=masks.device)
                pair_depths = scene_depth[:, None] * (masks[:, pi] | masks[:, pj])
                pair_ins = self._prep(pair_depths)                  # (C, P, S, S, 3)
                o = self._score_eval(model, scene_img, pair_ins, STYLE_ETS)
                gs_conf[:, pi, pj] = self._postprocess(o)[..., 0]
            neg = torch.full_like(gra_conf, -1e9)
            return SceneScores(
                gra_conf=torch.where(valid[..., None], gra_conf, neg),
                suc_conf=torch.where(valid[..., None], suc_conf, neg),
                gs_conf=gs_conf,
            )

    def _count_useful(self, valid) -> None:
        """Count the trunk images that a chunk's valid objects need
        (`trunk_images_useful`, on the card; _score_eval counts those
        sent): per scene with n valid objects, the R scene images of grasp
        and of suction if n > 0, the ETS scene image if a pair exists, 2n
        object images and the n(n-1)/2 pair images."""
        if self._useful_by_n is None:
            n = torch.arange(N_SLOTS + 1, device=valid.device)
            useful = 2 * self.cfg.model.num_rotations * (n > 0) + 2 * n
            if self.cfg.is_ets:
                pairs = n * (n - 1) // 2
                useful = useful + (pairs > 0) + pairs
            self._useful_by_n = useful
        profiling.count("trunk_images_useful", self._useful_by_n[valid.sum(dim=1)].sum())

    def score_scene_batch(self, state: TrainerState, scene_depths, masks,
                          valid) -> SceneScores:
        """Batched scoring over scenes in chunks of cfg.scene_chunk."""
        del state
        with profiling.span("score_scene_batch"):
            B = scene_depths.shape[0]
            step = max(1, min(self.cfg.scene_chunk, B))
            parts = [self.score_scene(scene_depths[i:i + step], masks[i:i + step],
                                      valid[i:i + step])
                     for i in range(0, B, step)]
            return SceneScores(*(torch.cat([getattr(p, f) for p in parts])
                                 for f in ("gra_conf", "suc_conf", "gs_conf")))

    def current_reward(self, choice, outcome) -> torch.Tensor:
        """Reward of the executed action (trainer.py:402-409)."""
        return torch.where(
            choice.action == ACTION_SUCTION, outcome.suction_success,
            torch.where(choice.action == ACTION_GRASP, outcome.grasp_success,
                        outcome.gs_success))

    def reactive_labels(self, choice, outcome) -> torch.Tensor:
        """Class per scene: 0 success / 1 failure; ETS succeeds only at
        reward 2.5 (trainer.py:390-400)."""
        success = torch.where(
            choice.action == ACTION_SUCTION, outcome.suction_success > 0,
            torch.where(choice.action == ACTION_GRASP, outcome.grasp_success > 0,
                        outcome.gs_success == 2.5))
        return torch.where(success, 0, 1).to(torch.int32)

    def dqn_labels(self, state: TrainerState, prev_choice, prev_outcome,
                   prev_objects_number, next_scene_depths, next_masks,
                   next_choice):
        """(labels, rewards) per scene: r + gamma Q_target(s', a*_online)
        (trainer.py:411-474), the target net scoring the online net's exploit
        choice on s'. The future term is zeroed on failure and on a cleared
        table (trainer.py:248-251)."""
        del state
        r = self.current_reward(prev_choice, prev_outcome)
        exploit = next_choice.exploit_action
        B = next_scene_depths.shape[0]
        bidx = torch.arange(B, device=next_masks.device)
        pick = lambda ids: next_masks[bidx, ids[:, 0].long()]  # noqa: E731
        mask_e = pick(next_choice.bestgs_g_id) | pick(next_choice.bestgs_s_id)
        ex = exploit[:, None, None]
        exec_mask = torch.where(
            ex == ACTION_GRASP, pick(next_choice.bestg_id),
            torch.where(ex == ACTION_SUCTION, pick(next_choice.bests_id), mask_e))
        style = torch.where(exploit == ACTION_GRASP, STYLE_GRASP,
                            torch.where(exploit == ACTION_SUCTION, STYLE_SUCTION,
                                        STYLE_ETS))
        # The exploit action's rotation (specific_rotation of the reference,
        # trainer.py:261-269); for ETS the grasp member's.
        rot_idx = torch.where(
            exploit == ACTION_GRASP, next_choice.bestg_id[:, 1],
            torch.where(exploit == ACTION_SUCTION, next_choice.bests_id[:, 1],
                        next_choice.bestgs_g_id[:, 1]))
        future = self._eval_styled(self.target, next_scene_depths, exec_mask, style,
                                   rot_idx)
        o = prev_outcome
        any_succ = (o.suction_success > 0) | (o.grasp_success > 0) | (o.gs_success > 0)
        n = prev_objects_number
        cleared = (((n == 1) & (o.suction_success == 1))
                   | ((n == 1) & (o.grasp_success == 1))
                   | ((n == 2) & (o.gs_success == 2.5)))
        future = torch.where(~any_succ | cleared, torch.zeros_like(future), future)
        return r + self.cfg.future_reward_discount * future, r

    @staticmethod
    def _style_groups(styles: torch.Tensor):
        """(style, scene indices) for each style present."""
        for s in (STYLE_GRASP, STYLE_SUCTION, STYLE_ETS):
            idx = torch.nonzero(styles == s)[:, 0]
            if idx.numel():
                yield s, idx

    @torch.no_grad()
    def _eval_styled(self, net: AffordanceNet, scene_depths, exec_masks,
                     styles, rotations=None) -> torch.Tensor:
        """Eval Q / confidence of (scene, exec-mask) pairs whose style varies
        per scene (trainer.py:581-634): one eval call per style present, M = 1
        mask per scene. (B, 224, 224) x2 + (B,) -> (B,). With R > 1 each
        scene stream turns by its `rotations` index (B,) times 2 pi / R
        (None: rotation 0)."""
        R = self.cfg.model.num_rotations
        out = torch.zeros(styles.shape[0], device=scene_depths.device)
        for s, idx in self._style_groups(styles):
            sd = scene_depths[idx]
            scene_img = self._prep(sd)
            if R > 1:
                rot = (torch.zeros_like(idx) if rotations is None else rotations[idx])
                scene_img = aff.rotate_image_nearest(scene_img, aff.rotation_angles(rot, R))
            o = self._score_eval(net, scene_img, self._prep(sd * exec_masks[idx])[:, None], s)
            out[idx] = self._postprocess(o[:, 0])[:, 0]
        return out

    def update(self, state: TrainerState, exp: Experience, labels: torch.Tensor):
        """One Adam step on the batch of executed experiences
        (trainer.py:640-761). labels: (B,) float Q targets (DQN) or class
        labels (reactive). Invalid experiences contribute 0 loss but still
        run forward, so their BatchNorm statistics count in the mean.
        Returns (new TrainerState, loss)."""
        cfg, model = self.cfg, self.model
        B = exp.style.shape[0]
        with profiling.span("update"):
            if bool(((exp.style < STYLE_GRASP) | (exp.style > STYLE_ETS)).any()):
                raise ValueError("experience styles must be 0, 1 or 2")
            model.zero_grad(set_to_none=True)
            loss_b = torch.zeros(B, device=self.device)
            stats: dict = {}
            for s, idx in self._style_groups(exp.style):
                with profiling.span("update.forward", style=s):
                    sd = exp.scene_depth[idx]
                    out, new = model.score_train(self._prep(sd),
                                                 self._prep(sd * exp.exec_mask[idx]),
                                                 s, cfg.fast_train_conv2)
                    if cfg.method == "reactive":
                        loss_s = losses.reactive_ce(out, labels[idx])
                    else:
                        loss_s = losses.huber_q(out[:, 0], labels[idx])
                    loss_b = loss_b.index_put((idx,), loss_s)
                for bn, mv in new.items():
                    stats.setdefault(bn, []).append((idx, mv))
            loss_b = torch.where(exp.valid, loss_b, torch.zeros_like(loss_b))
            n_valid = exp.valid.sum()
            red = self.reducer
            if red is not None:
                n_valid = red.all_sum(n_valid)
            loss = loss_b.sum() / n_valid.clamp(min=1)
            with profiling.span("update.backward"):
                loss.backward()
            with profiling.span("update.adam"):
                # optax steps every parameter (moment decay, step count); torch's
                # Adam skips one whose grad is None (unused styles, a tied gs_head,
                # a batch with no valid scene), so give those a zero gradient. It
                # also keeps the reducer's flat buffer the same on every rank.
                for p in model.parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if red is not None:
                    red.sum_grads(list(model.parameters()))
                    loss = red.all_sum(loss)
                self.opt.step()
            with profiling.span("update.bn_stats"), torch.no_grad():
                per_scene = {}
                for bn, parts in stats.items():
                    per_scene[bn] = []
                    for k, old in enumerate((bn.running_mean, bn.running_var)):
                        ps = old.expand(B, -1).clone()
                        for idx, mean_var in parts:
                            ps[idx] = mean_var[k]
                        per_scene[bn].append(ps)
                new = (red.mean_stats(model, per_scene, B) if red is not None else
                       {bn: [ps.mean(dim=0) for ps in v] for bn, v in per_scene.items()})
                for bn, (mean, var) in new.items():
                    bn.running_mean.copy_(mean)
                    bn.running_var.copy_(var)
            state = TrainerState(iteration=state.iteration + 1)
            if cfg.method == "reinforcement":
                self.maybe_sync_target(state)
        return state, loss.detach()
