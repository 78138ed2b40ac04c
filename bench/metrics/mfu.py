"""An iteration's or step's FLOPs (``bench/counts``) a second over the
peak of the configuration's precision (float32 outside the tensor cores,
or bf16 on them), in %."""
from benchlib.readers import mfu_percent as read  # noqa: F401
