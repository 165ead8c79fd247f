"""DeepFM: FM + deep MLP over 39 sparse fields. [arXiv:1703.04247]"""

from repro_torch.models.recsys import RecsysConfig

FAMILY = "recsys"

CONFIG = RecsysConfig(
    name="deepfm", kind="deepfm", n_sparse=39, embed_dim=10,
    rows_per_field=1_000_000, mlp=(400, 400, 400), dtype="float32",
)

REDUCED = RecsysConfig(
    name="deepfm-reduced", kind="deepfm", n_sparse=8, embed_dim=6,
    rows_per_field=128, mlp=(32, 32), dtype="float32",
)
