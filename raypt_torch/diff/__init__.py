from .params import SceneParams, apply_params, freeze_except
from .inverse import (fit, l2_image_loss, make_fit_step, stack_views,
                      view_at)
