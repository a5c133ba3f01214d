"""Impedance mapping: intensity -> acoustic impedance.  The tissue-table
interpolant, the learned MLP and the CT Hounsfield models, as in
``diffus_tpu/impedance/__init__.py``."""

from diffus_tpu_torch.impedance.preproc import brain_mask, zscore_normalize, minmax_normalize
from diffus_tpu_torch.impedance.table import (
    TISSUE_TABLE,
    TISSUE_TABLE_NO_BONE,
    table_arrays,
    piecewise_impedance,
    tabular_impedance_volume,
    default_table_points,
)
from diffus_tpu_torch.impedance.mlp import (
    ImpedanceMLP,
    init_params,
    train_on_table,
    fit_table_mlp,
    impedance_volume_masked,
    impedance_volume_normalized,
    impedance_slice_zscore,
)
from diffus_tpu_torch.impedance.ct import (
    schneider_webb_impedance,
    crude_ct_impedance,
    density_from_hu,
    speed_from_hu,
)
