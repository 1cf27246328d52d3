from .sharding import (default_mesh, init_distributed,
                       loss_and_grad_sharded, render_frame_sharded)
