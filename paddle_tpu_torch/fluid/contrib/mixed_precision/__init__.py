"""AMP (counterpart of paddle_tpu/fluid/contrib/mixed_precision/;
reference: python/paddle/fluid/contrib/mixed_precision/ — decorator.py:218
decorate → OptimizerWithMixedPrecision:27, the white and black op lists,
cast insertion, dynamic loss scaling).

The reduced precision is bfloat16, which needs no loss scaling (the
exponent range of f32). ``decorate`` rewrites the inputs of matmul-type
ops (white list) to bf16 and keeps softmax and norm accumulation in f32
(black list); ``use_fp16=True`` turns on the loss-scaling machinery
(static or dynamic) that an fp16 run needs."""
from .decorator import decorate, AutoMixedPrecisionLists  # noqa: F401
