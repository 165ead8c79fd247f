"""Two-tower retrieval with in-batch sampled softmax (Yi et al. RecSys'19).

The arch where the paper's technique lands *directly*: retrieval_cand is
first-stage candidate generation with a per-query anytime budget.  The
dense Stage-1 modality's ``two_tower`` embedding source runs ``REDUCED``'s
tower (``repro_torch.dense.embeddings``)."""

from repro_torch.models.recsys import RecsysConfig

FAMILY = "recsys"

CONFIG = RecsysConfig(
    name="two-tower-retrieval", kind="two_tower", embed_dim=256,
    tower_mlp=(1024, 512, 256), n_users=8_000_000, n_items=2_000_000,
    n_user_feats=16, n_item_feats=8, dtype="float32",
)

REDUCED = RecsysConfig(
    name="two-tower-reduced", kind="two_tower", embed_dim=32,
    tower_mlp=(64, 32), n_users=1024, n_items=512, n_user_feats=4,
    n_item_feats=2, dtype="float32",
)
