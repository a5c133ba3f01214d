"""Training: losses, renderer-in-the-loop impedance training, pose
recovery, the multi-case driver, checkpoints and metrics
(``diffus_tpu/train/__init__.py``)."""

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
from diffus_tpu_torch.train.pose_recovery import (
    PoseRecoveryConfig,
    AnnealedPoseConfig,
    render_pose,
    gaussian_blur_frame,
    recover_pose,
    recover_pose_multistart,
    sample_init_poses,
    recover_pose_annealed,
    recover_pose_multistart_annealed,
    score_poses,
    recover_pose_global,
    pose_recovery_benchmark,
    pose_recovery_envelope,
    recover_free,
)
from diffus_tpu_torch.train.driver import CaseSpec, train_impedance_cases
from diffus_tpu_torch.train.checkpoint import save_checkpoint, load_checkpoint
from diffus_tpu_torch.train.metrics import MetricsLogger
