"""Model diagnostics (port of photon_ml_tpu/diagnostics), with the same exports."""
from photon_ml_tpu_torch.diagnostics.metrics import evaluate_glm, evaluate_scores  # noqa: F401
from photon_ml_tpu_torch.diagnostics.bootstrap import (  # noqa: F401
    BootstrapReport, CoefficientSummary, bootstrap_training,
)
from photon_ml_tpu_torch.diagnostics.hl import HosmerLemeshowReport, hosmer_lemeshow  # noqa: F401
from photon_ml_tpu_torch.diagnostics.independence import KendallTauReport, kendall_tau_analysis  # noqa: F401
from photon_ml_tpu_torch.diagnostics.importance import FeatureImportanceReport, feature_importance  # noqa: F401
from photon_ml_tpu_torch.diagnostics.fitting import FittingReport, fitting_diagnostic  # noqa: F401
from photon_ml_tpu_torch.diagnostics.report import (DiagnosticReport,  # noqa: F401
                                                    render_html, render_markdown)
