"""The production configuration, in one place (port of smg_tpu/train/prod_config.py).

DenseNet-121 trunks at input 224, the double-DQN head (num_out 1), PE+OO
geometry, lightly cluttered scenes, exact segmentation, batched executor.
"""

from __future__ import annotations


def make_prod_trainer(batch_size: int, device="cuda"):
    """Trainer for the production DenseNet-121 @224 DQN configuration."""
    from smg_tpu_torch.models.affordance import ModelConfig
    from smg_tpu_torch.train.trainer import TrainConfig, Trainer

    return Trainer(TrainConfig(
        model=ModelConfig(method="reinforcement", input_size=224),
        method="reinforcement", scene_chunk=min(batch_size, 8),
    ), device=device)


def make_prod_loop_cfg(batch_size: int, is_testing: bool = False):
    """LoopConfig of the flagship eses_drl_lc episode loop. The port runs
    it with is_testing=True (the act step)."""
    from smg_tpu_torch.envs.smg_env import EnvConfig
    from smg_tpu_torch.train.loop import LoopConfig

    return LoopConfig(
        env=EnvConfig(is_pe=True, is_oo=True, method="reinforcement",
                      is_testing=is_testing),
        batch_size=batch_size,
    )
