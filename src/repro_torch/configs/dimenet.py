"""DimeNet: directional message passing GNN. [arXiv:2003.03123]"""

from repro_torch.models.gnn import DimeNetConfig

FAMILY = "gnn"

CONFIG = DimeNetConfig(
    name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
    n_radial=6, d_feat=16, dtype="float32",
)

REDUCED = DimeNetConfig(
    name="dimenet-reduced", n_blocks=2, d_hidden=32, n_bilinear=4,
    n_spherical=3, n_radial=4, d_feat=8, dtype="float32",
)
