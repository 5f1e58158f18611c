"""The multistage trainer: batched scoring, DQN labels, the update
(port of smg_tpu/train/trainer.py).

- `score_scene_batch`: the online net's eval scores (trainer.py:282-384)
  at ModelConfig.num_rotations R rotations of the scene stream (rotation
  0 the unrotated image), including the ETS pair branch, which stays at
  rotation 0. Only the valid objects and pairs are scored, as the SMG
  reference scores the objects segmentation finds (main.py:158-192):
  `valid` is read to the host once, and each style's trunk calls are
  packed with consecutive scenes' images (a scene's R scene images and
  one image per valid object, or its rotation-0 scene image and one per
  valid pair) up to `Trainer.image_budget`, the largest call of
  `scene_chunk` scenes with every slot scored, which bounds memory (eval
  BatchNorm makes the per-image math that of the JAX package's batch-1
  units). The entries arbitration never reads hold -1e9 (objects) and
  -100 (pairs), PARITY dev 18.
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
_PAIR_SLOTS = np.stack([_PI, _PJ], 1)   # (N_PAIRS, 2): pair p's two slots


def pack_calls(units: list, per_scene: int, budget: int) -> list:
    """Group consecutive scenes' scoring units into trunk calls of at most
    `budget` images. units: [(scene, (n, k) slots of its n units)], each
    scene needing per_scene scene images beside one image per unit. A call
    takes whole scenes while the next fits; a scene that alone exceeds the
    budget is split into parts, each with its scene images again. ->
    [[(scene, slots), ...] per call]."""
    if budget <= per_scene:
        raise ValueError(f"an image budget of {budget} holds no unit beside "
                         f"{per_scene} scene images")
    calls, cur, used = [], [], 0
    for b, u in units:
        while len(u):
            room = budget - used - per_scene
            if room < min(len(u), budget - per_scene):
                calls.append(cur)
                cur, used = [], 0
                continue
            part, u = u[:room], u[room:]
            cur.append((b, part))
            used += per_scene + len(part)
    if cur:
        calls.append(cur)
    return calls


def _call_index(call: list, per_scene: int) -> list:
    """Host index arrays of one packed call: its scenes, each unit's scene,
    the head's rows ordered (unit, scene image), pairing scene image rows
    part * per_scene + r with each unit's own row after all scene images,
    then each of the units' k slot columns (one an object, two a pair)."""
    counts = [len(u) for _, u in call]
    slots = np.concatenate([u for _, u in call])
    part = np.repeat(np.arange(len(call)), counts)
    scene_rows = (part[:, None] * per_scene + np.arange(per_scene)).reshape(-1)
    mask_rows = np.repeat(len(call) * per_scene + np.arange(len(slots)), per_scene)
    scenes = np.array([b for b, _ in call])
    return [scenes, np.repeat(scenes, counts), scene_rows, mask_rows, *slots.T]


def _to_device(index: list, device) -> list:
    """Lists of host index arrays -> the same lists of int64 tensors on
    `device`, through one copy that does not wait for the device's queue
    (pinned memory, non-blocking, on a CUDA device)."""
    arrays = [a for arrs in index for a in arrs]
    if not arrays:
        return []
    flat = torch.from_numpy(np.concatenate(arrays).astype(np.int64))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    parts = iter(torch.split(flat, [len(a) for a in arrays]))
    return [[next(parts) for _ in arrs] for arrs in index]


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
    # Scoring's memory bound: a packed trunk call gets at most the images of
    # this many scenes with every slot scored (Trainer.image_budget).
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

    def _score_rows(self, x, scene_rows, mask_rows, style: int) -> torch.Tensor:
        """Eval scores (Q, num_out) of one packed trunk call of the online
        net (score_eval_rows, or the module forward score_rows, as
        TrainConfig.fast_eval resolves)."""
        with profiling.span("score_eval", style=style):
            if profiling.enabled():
                profiling.count("trunk_images", x.shape[0])
            if self.use_fast_eval:
                return self.model.score_eval_rows(x, scene_rows, mask_rows, style)
            return self.model.score_rows(x, scene_rows, mask_rows, style)

    def _postprocess(self, out: torch.Tensor) -> torch.Tensor:
        """(..., num_out) -> (..., 1): P(class 0) for reactive, raw Q
        for reinforcement (trainer.py:360-368)."""
        if self.cfg.method == "reactive":
            return torch.softmax(out, dim=-1)[..., :1]
        return out

    def _rotated_scenes(self, scene_img: torch.Tensor) -> torch.Tensor:
        """(C, S, S, 3) -> (C, R, S, S, 3): rotation r turns each scene by
        r 2 pi / R, its angle rounded once to float32 (trainer.py:305-310);
        rotation 0 is the image itself. The angles are made on the device,
        so no copy from the host waits for its queue."""
        R = self.cfg.model.num_rotations
        if R == 1:
            return scene_img[:, None]
        theta = (torch.arange(R, dtype=torch.float64, device=scene_img.device)
                 * (2.0 * math.pi / R)).float()
        return aff.rotate_image_nearest(
            scene_img[:, None].expand((-1, R) + scene_img.shape[1:]), theta)

    @property
    def image_budget(self) -> int:
        """The most images one packed trunk call of score_scene_batch gets:
        the largest call of scene_chunk scenes with every slot scored,
        R + N_SLOTS a scene, or 1 + N_PAIRS with ETS. It bounds the memory
        peak and every kernel's element count (ops/_build.py::check_int32)."""
        per_scene = self.cfg.model.num_rotations + N_SLOTS
        if self.cfg.is_ets:
            per_scene = max(per_scene, 1 + N_PAIRS)
        return max(1, self.cfg.scene_chunk) * per_scene

    def _useful_images(self, n: np.ndarray) -> int:
        """The trunk images that scenes with n valid objects need: the R
        scene images of grasp and of suction if n > 0, the ETS scene image
        if a pair exists, 2n object images and the n(n-1)/2 pair images."""
        useful = 2 * self.cfg.model.num_rotations * (n > 0) + 2 * n
        if self.cfg.is_ets:
            pairs = n * (n - 1) // 2
            useful = useful + (pairs > 0) + pairs
        return int(useful.sum())

    def _call_images(self, scene_depths, masks, scenes, unit_scene, slots,
                     per_scene: int) -> torch.Tensor:
        """One packed call's trunk images, made through one _prep: the scene
        images of `scenes`, per_scene (R > 1) rotations each, then one image
        per unit, its scene's depth under the union of its `slots` masks
        (one slot an object, two a pair)."""
        unit_mask = masks[unit_scene, slots[0]]
        for s in slots[1:]:
            unit_mask = unit_mask | masks[unit_scene, s]
        x = self._prep(torch.cat([scene_depths[scenes], scene_depths[unit_scene] * unit_mask]))
        if per_scene > 1:
            G = scenes.shape[0]
            x = torch.cat([self._rotated_scenes(x[:G]).flatten(0, 1), x[G:]])
        return x

    def score_scene_batch(self, state: TrainerState, scene_depths, masks,
                          valid) -> SceneScores:
        """Score B scenes: (B, 224, 224) masked depth, (B, N, 224, 224)
        masks, (B, N) valid (trainer.py:282-358): grasp and suction of each
        valid object at each of the R rotations, ETS of each pair of valid
        objects at rotation 0 (:325), in packed trunk calls (pack_calls);
        -1e9 (objects) and -100 (pairs) elsewhere. Reading `valid` is its one
        wait for the device."""
        del state
        with profiling.span("score_scene_batch"):
            cfg, R = self.cfg, self.cfg.model.num_rotations
            B, dev = scene_depths.shape[0], scene_depths.device
            ok = valid.cpu().numpy()
            n = ok.sum(axis=1)
            if profiling.enabled():
                profiling.count("trunk_images_useful", self._useful_images(n))
            gra_conf = torch.full((B, N_SLOTS, R), -1e9, device=dev)
            suc_conf = torch.full((B, N_SLOTS, R), -1e9, device=dev)
            gs_conf = torch.full((B, N_SLOTS, N_SLOTS), -100.0, device=dev)
            objects = pack_calls([(b, np.flatnonzero(ok[b])[:, None]) for b in range(B)
                                  if n[b]], R, self.image_budget)
            pairs = []
            if cfg.is_ets:
                pair_ok = ok[:, _PI] & ok[:, _PJ]
                pairs = pack_calls([(b, _PAIR_SLOTS[pair_ok[b]]) for b in range(B)
                                    if pair_ok[b].any()], 1, self.image_budget)
            index = _to_device([_call_index(c, R) for c in objects]
                               + [_call_index(c, 1) for c in pairs], dev)
            for scenes, unit_scene, srow, mrow, slot in index[:len(objects)]:
                x = self._call_images(scene_depths, masks, scenes, unit_scene, (slot,), R)
                for style, conf in ((STYLE_GRASP, gra_conf), (STYLE_SUCTION, suc_conf)):
                    out = self._postprocess(self._score_rows(x, srow, mrow, style))
                    conf[unit_scene, slot] = out[:, 0].reshape(-1, R)
            for scenes, unit_scene, srow, mrow, pi, pj in index[len(objects):]:
                x = self._call_images(scene_depths, masks, scenes, unit_scene, (pi, pj), 1)
                out = self._postprocess(self._score_rows(x, srow, mrow, STYLE_ETS))
                gs_conf[unit_scene, pi, pj] = out[:, 0]
            return SceneScores(gra_conf=gra_conf, suc_conf=suc_conf, gs_conf=gs_conf)

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
