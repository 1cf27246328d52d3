from .obj import load_obj, smooth_normals
from .ply import PLYError, load_mesh, load_ply
from .gltf import GLTFError, load_gltf
from .dds import load_dds, load_env_cubemap, DDSError
from .hdr import load_hdr, write_hdr
from .image import write_png, write_ppm, read_ppm, write_npy
from .checkpoint import (load_pytree, load_render_state, save_pytree,
                         save_render_state)
