"""Training: losses, renderer-in-the-loop impedance training, checkpoints
and metrics (``diffus_tpu/train/__init__.py``).  Pose recovery and the
multi-case driver are not ported yet (ROADMAP A10, A9)."""

from diffus_tpu_torch.train.losses import (
    ssim,
    ssim_loss,
    masked_mse,
    gradient_loss,
    masked_mse_edge_loss,
)
from diffus_tpu_torch.train.impedance_train import (
    ImpedanceTrainConfig,
    synth_forward,
    synth_loss,
    make_optimizer,
    train_step,
    train_impedance_scan,
    train_impedance,
    train_impedance_checkpointed,
)
from diffus_tpu_torch.train.checkpoint import save_checkpoint, load_checkpoint
from diffus_tpu_torch.train.metrics import MetricsLogger
