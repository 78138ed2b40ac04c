"""Peak allocated device memory of a cell's run, GB."""
from benchlib.readers import peak_gb as read  # noqa: F401
