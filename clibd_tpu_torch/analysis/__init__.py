"""Analysis and plotting: the port of `clibd_tpu/analysis/__init__.py`, with its 32
exports.  Every module here imports numpy only; h5py, matplotlib and sklearn are
imported where a file is read or a figure drawn."""

from .compare import (
    add_harmonic_mean_acc,
    load_experiment_acc_dicts,
    plot_multi_experiment_all_in_one,
    plot_multi_experiment_comparison,
)
from .distributions import (
    nearest_same_species_distances,
    plot_similarity_distributions,
    silhouette_summary,
    similarity_distribution_rows,
    write_distance_csv,
)
from .per_class import (
    avg_acc_by_key_count,
    per_class_acc_vs_key_count,
    plot_per_class_acc_vs_key_count,
    pretrain_seen_unseen_overlap,
    recompute_acc_from_predictions,
    unique_counts_summary,
)
from .plots import (
    generate_embedding_plot,
    plot_confusion_matrix,
    project_2d,
    retrieve_images_grid,
    select_plot_indices,
)
from .report import eval_report_sections, write_html_report
from .statistics import (
    count_frequencies,
    overlap_statistics,
    plot_records_per_class_histogram,
    range_histogram,
    split_level_counts,
    write_statistics_csvs,
)
from .tables import (
    dataset_statistics,
    flatten_results_csv,
    latex_accuracy_table,
    results_csv_rows,
)

__all__ = [
    "add_harmonic_mean_acc",
    "avg_acc_by_key_count",
    "count_frequencies",
    "dataset_statistics",
    "eval_report_sections",
    "flatten_results_csv",
    "generate_embedding_plot",
    "latex_accuracy_table",
    "load_experiment_acc_dicts",
    "nearest_same_species_distances",
    "overlap_statistics",
    "per_class_acc_vs_key_count",
    "plot_confusion_matrix",
    "plot_multi_experiment_all_in_one",
    "plot_multi_experiment_comparison",
    "plot_per_class_acc_vs_key_count",
    "plot_records_per_class_histogram",
    "plot_similarity_distributions",
    "pretrain_seen_unseen_overlap",
    "project_2d",
    "range_histogram",
    "recompute_acc_from_predictions",
    "results_csv_rows",
    "retrieve_images_grid",
    "select_plot_indices",
    "silhouette_summary",
    "similarity_distribution_rows",
    "split_level_counts",
    "unique_counts_summary",
    "write_distance_csv",
    "write_html_report",
    "write_statistics_csvs",
]
