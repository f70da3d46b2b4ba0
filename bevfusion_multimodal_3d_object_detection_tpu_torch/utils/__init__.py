"""Weight conversion, BatchNorm folding, device choice, metrics, AOT
serving artifacts, profiling and the kernel build cache."""

from .metrics import (  # noqa: F401
    calculate_ap,
    compute_center_distance_matrix,
    compute_metrics,
    match_predictions_to_gt,
    save_and_print_metrics,
)
