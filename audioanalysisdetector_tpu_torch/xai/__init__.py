"""XAI subsystem (PyTorch port): gradient attribution on autograd,
perturbation attribution in batched forwards, LIME with a numpy surrogate,
windowed kernel-SHAP of the GMM scorer, comparisons, plots and the HTML
report (plots skip without matplotlib)."""

from audioanalysisdetector_tpu_torch.xai.attribution import (
    bilstm_heatmaps,
    grad_cam,
    integrated_gradients,
    occlusion,
    saliency,
)
from audioanalysisdetector_tpu_torch.xai.compare import (
    compare_gmm_bilstm,
    extract_top_intervals_global,
    plot_heatmaps,
)
from audioanalysisdetector_tpu_torch.xai.lime import (
    fit_surrogate,
    kernel_weights,
    lime_dataset,
    lime_single_instance,
    perturb_random_features_mean,
    perturb_segments,
    signal_segmentation,
)
from audioanalysisdetector_tpu_torch.xai.report import write_explanation_html
from audioanalysisdetector_tpu_torch.xai.shap_gmm import gmm_shap, time_windows
from audioanalysisdetector_tpu_torch.xai.visualize import (
    plot_cqcc_pipeline,
    plot_gradcam_overlay,
    visualize_feature_perturbation,
    visualize_segment_perturbation,
)

__all__ = [
    "bilstm_heatmaps",
    "compare_gmm_bilstm",
    "extract_top_intervals_global",
    "fit_surrogate",
    "gmm_shap",
    "grad_cam",
    "integrated_gradients",
    "kernel_weights",
    "lime_dataset",
    "lime_single_instance",
    "occlusion",
    "perturb_random_features_mean",
    "perturb_segments",
    "plot_cqcc_pipeline",
    "plot_gradcam_overlay",
    "plot_heatmaps",
    "saliency",
    "signal_segmentation",
    "time_windows",
    "visualize_feature_perturbation",
    "visualize_segment_perturbation",
    "write_explanation_html",
]
