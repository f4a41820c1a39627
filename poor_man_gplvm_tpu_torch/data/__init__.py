"""Data ingestion layer: loaders, binning, bursts, CV, baseline decoders.

Counterpart of ``poor_man_gplvm_tpu/data``, in the port's own copy (torch,
numpy and scipy; no JAX, no pandas at import): the host-side loaders and
binner (``native`` is the C++ spike binner, built at first use) that make
the (N, T) counts the models fit, and the naive-Bayes baseline decoders,
which compute in float64 on the card.  Where a JAX loader returns a
DataFrame this returns ``utils.table.ResultTable``.
"""

from poor_man_gplvm_tpu_torch.data.behavior import (
    align_brain_and_behavior,
    load_behavior,
)
from poor_man_gplvm_tpu_torch.data.binning import (
    bin_spikes_sliding,
    compute_spike_counts,
    smooth_and_zscore,
)
from poor_man_gplvm_tpu_torch.data.bursts import (
    detect_population_bursts,
    merge_overlapping_bursts_two_probes,
)
from poor_man_gplvm_tpu_torch.data.cellexplorer import (
    load_cell_metrics,
    mat_struct_to_dict,
)
from poor_man_gplvm_tpu_torch.data.cv import DecoderDataset, cv_split
from poor_man_gplvm_tpu_torch.data.decoders import (
    GaussianBayesDecoder,
    PoissonBayesDecoder,
)
from poor_man_gplvm_tpu_torch.data.grouping import (
    collect_matrix_for,
    collect_matrix_for_bilat,
    sort_units,
)
from poor_man_gplvm_tpu_torch.data.kilosort import (
    compute_spike_counts_old,
    compute_spike_rates,
    load_cluster_labels,
)
from poor_man_gplvm_tpu_torch.data.moser import preprocess_moser_data
from poor_man_gplvm_tpu_torch.data.quality import get_presence_ratio

__all__ = [
    "align_brain_and_behavior",
    "bin_spikes_sliding",
    "collect_matrix_for",
    "collect_matrix_for_bilat",
    "compute_spike_counts",
    "compute_spike_counts_old",
    "compute_spike_rates",
    "cv_split",
    "DecoderDataset",
    "detect_population_bursts",
    "GaussianBayesDecoder",
    "get_presence_ratio",
    "load_behavior",
    "load_cell_metrics",
    "load_cluster_labels",
    "mat_struct_to_dict",
    "merge_overlapping_bursts_two_probes",
    "PoissonBayesDecoder",
    "preprocess_moser_data",
    "smooth_and_zscore",
    "sort_units",
]
