"""The two-tower retrieval configuration the dense modality embeds with.

Only ``REDUCED`` is ported: the tower the dense Stage-1 modality's
``two_tower`` embedding source runs (``repro_torch.dense.embeddings``).
"""

from repro_torch.models.recsys import TwoTowerConfig

# the reference's REDUCED ("two-tower-reduced"): 32-wide outputs
REDUCED = TwoTowerConfig(tower_mlp=(64, 32), n_users=1024, n_items=512)
