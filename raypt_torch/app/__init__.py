from .metrics import RenderMetrics, Timer, log_step
from .profiling import time_fn, trace, rays_per_sec
