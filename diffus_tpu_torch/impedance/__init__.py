"""Impedance mapping: intensity -> acoustic impedance.  This slice ports
the tissue-table interpolant; the MLP and CT models come later."""

from diffus_tpu_torch.impedance.table import (
    TISSUE_TABLE,
    piecewise_impedance,
    tabular_impedance_volume,
    default_table_points,
)
