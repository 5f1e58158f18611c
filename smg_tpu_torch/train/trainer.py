"""The scoring half of the multistage trainer (port of smg_tpu/train/trainer.py).

Ported: TrainConfig, Trainer.score_scene / score_scene_batch (including the
ETS pair branch, trainer.py:315-327), _postprocess and current_reward.
Labels, the update and Adam arrive with the training-step port.

`scene_chunk` bounds memory only: every scoring unit of a chunk of scenes
goes into one trunk call per style (the JAX package maps one unit of
B = 1 scene at a time; eval BatchNorm makes the per-image math the same).
"""

from __future__ import annotations

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

_PI, _PJ = np.triu_indices(N_SLOTS, k=1)
N_PAIRS = int(_PI.shape[0])


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    method: str = "reinforcement"
    is_ets: bool = False
    scene_chunk: int = 4


@dataclass
class TrainerState:
    """What the act step carries of the trainer: the global iteration.
    The online net's weights live in Trainer.model."""

    iteration: int = 0


@dataclass
class Experience(_Batched):
    scene_depth: torch.Tensor   # (B, 224, 224)
    exec_mask: torch.Tensor     # (B, 224, 224) bool
    style: torch.Tensor         # (B,) int32
    valid: torch.Tensor         # (B,) bool


@dataclass
class SceneScores(_Batched):
    gra_conf: torch.Tensor   # (B, N, 1): one rotation
    suc_conf: torch.Tensor   # (B, N, 1)
    gs_conf: torch.Tensor    # (B, N, N)


class Trainer:
    """Owns the online AffordanceNet on `device`."""

    def __init__(self, cfg: TrainConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = AffordanceNet(cfg.model).to(self.device).eval()

    def init_state(self, generator: torch.Generator) -> TrainerState:
        """Seeded He init of the online net (PARITY dev 4)."""
        aff.init_params(self.model, generator)
        return TrainerState(iteration=0)

    def _prep(self, depth):
        return aff.preprocess_depth(depth, self.cfg.model)

    def _postprocess(self, out: torch.Tensor) -> torch.Tensor:
        """(..., num_out) -> (..., 1): P(class 0) for reactive, raw Q
        for reinforcement (trainer.py:360-368)."""
        if self.cfg.method == "reactive":
            return torch.softmax(out, dim=-1)[..., :1]
        return out

    def score_scene(self, scene_depth, masks, valid) -> SceneScores:
        """Score scenes: (C, 224, 224) masked depth, (C, N, 224, 224)
        masks, (C, N) valid (trainer.py:282-358), at the one rotation of
        the reference (gnum/snum_rotations = 1)."""
        cfg = self.cfg
        model = self.model
        C = scene_depth.shape[0]
        scene_img = self._prep(scene_depth)                     # (C, S, S, 3)
        obj_ins = self._prep(scene_depth[:, None] * masks)      # (C, N, S, S, 3)
        gra_conf = self._postprocess(model.score_eval(scene_img, obj_ins,
                                                      STYLE_GRASP))
        suc_conf = self._postprocess(model.score_eval(scene_img, obj_ins,
                                                      STYLE_SUCTION))
        gs_conf = torch.full((C, N_SLOTS, N_SLOTS), -100.0,
                             device=scene_depth.device)
        if cfg.is_ets:
            pi = torch.as_tensor(_PI, device=masks.device)
            pj = torch.as_tensor(_PJ, device=masks.device)
            pair_depths = scene_depth[:, None] * (masks[:, pi] | masks[:, pj])
            pair_ins = self._prep(pair_depths)                  # (C, P, S, S, 3)
            o = model.score_eval(scene_img, pair_ins, STYLE_ETS)
            gs_conf[:, pi, pj] = self._postprocess(o)[..., 0]
        neg = torch.full_like(gra_conf, -1e9)
        return SceneScores(
            gra_conf=torch.where(valid[..., None], gra_conf, neg),
            suc_conf=torch.where(valid[..., None], suc_conf, neg),
            gs_conf=gs_conf,
        )

    def score_scene_batch(self, state: TrainerState, scene_depths, masks,
                          valid) -> SceneScores:
        """Batched scoring over scenes in chunks of cfg.scene_chunk."""
        del state
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
