"""xDeepFM: compressed interaction network (CIN) 200-200-200 + deep MLP.
[arXiv:1803.05170]"""

from repro_torch.models.recsys import RecsysConfig

FAMILY = "recsys"

CONFIG = RecsysConfig(
    name="xdeepfm", kind="xdeepfm", n_sparse=39, embed_dim=10,
    rows_per_field=1_000_000, cin_layers=(200, 200, 200), mlp=(400, 400),
    dtype="float32",
)

REDUCED = RecsysConfig(
    name="xdeepfm-reduced", kind="xdeepfm", n_sparse=8, embed_dim=6,
    rows_per_field=128, cin_layers=(16, 16), mlp=(32,), dtype="float32",
)
