from diffus_tpu_torch.io.nifti import load_nifti, load_volume, save_nifti
from diffus_tpu_torch.io.datasets import (
    MedicalVolumeDataset,
    MRIDataset,
    iUSDataset,
    RemindCase,
    find_remind_cases,
    CASE_PRESETS,
    scene_from_preset,
)
from diffus_tpu_torch.io.native import (
    native_available,
    load_nifti_native,
    load_nifti_fast,
    load_nifti_batch,
    save_nifti_native,
    save_nifti_fast,
)
from diffus_tpu_torch.io.pipeline import VolumePrefetcher, batched, iterate_cases
