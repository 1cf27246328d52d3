from .envmap import (build_env_quads, rotate_y_pi, sample_env,
                     sample_env_quads)
from .integrator import (accumulate, camera_rays_for_ids, make_finder,
                         pixel_id_grid, render_aovs, render_frame,
                         render_sample, trace_paths)
from .shading import ShadeTables, build_shade_tables, recompute_hit_packed
from .tonemap import to_display, to_u8
