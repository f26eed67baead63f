from .config import (ALL_SHAPES, DECODE_32K, LONG_500K, ModelConfig,
                     PREFILL_32K, ShapeSpec, TRAIN_4K, shape_by_name)
from .registry import Model, get_model
