# Roofline model of the counting kernels on the H100 and the autotuner that
# consumes it (the JAX package's analysis of the LLM scaffold is not ported).
from . import autotune
from .autotune import (LaunchConfig, TuningTable, derived_chooser_thresholds,
                       resolve_launch_config, staleness_report)
from .kernel_model import (geometry_bucket, kernel_bytes, kernel_flops,
                           predicted_seconds, record_launch)
