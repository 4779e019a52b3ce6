from photon_ml_tpu_torch.evaluation.evaluators import (  # noqa: F401
    AUC, LOGISTIC_LOSS, POISSON_LOSS, RMSE, SMOOTHED_HINGE_LOSS, SQUARED_LOSS,
    Evaluator, MultiEvaluator, area_under_roc_curve,
    default_evaluator_for_task, default_validation_evaluator_for_task,
    parse_evaluator, precision_at_k, rmse,
)
