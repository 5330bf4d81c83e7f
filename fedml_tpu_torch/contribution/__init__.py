"""Client and feature contribution measurement (reference
fedml_api/contribution/): leave-one-out influence for horizontal FL and
kernel SHAP (plain and federated-feature) for vertical FL."""

from fedml_tpu_torch.contribution.loo import LeaveOneOutMeasure
from fedml_tpu_torch.contribution.shap import (kernel_shap,
                                               kernel_shap_federated,
                                               kernel_shap_federated_with_step,
                                               shapley_kernel_weight)

__all__ = [
    "LeaveOneOutMeasure", "kernel_shap", "kernel_shap_federated",
    "kernel_shap_federated_with_step", "shapley_kernel_weight",
]
