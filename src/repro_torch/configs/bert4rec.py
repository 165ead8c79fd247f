"""BERT4Rec: bidirectional transformer over item sequences (encoder-only —
no autoregressive decode shapes). [arXiv:1904.06690]"""

from repro_torch.models.recsys import RecsysConfig

FAMILY = "recsys"

CONFIG = RecsysConfig(
    name="bert4rec", kind="bert4rec", embed_dim=64, n_blocks=2, n_heads=2,
    seq_len=200, n_items=1_000_000, dtype="float32",
)

REDUCED = RecsysConfig(
    name="bert4rec-reduced", kind="bert4rec", embed_dim=16, n_blocks=2,
    n_heads=2, seq_len=24, n_items=256, dtype="float32",
)
