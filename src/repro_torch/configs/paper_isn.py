"""The paper's own architecture: a hybrid first-stage ISN (index server
node) — document-sharded BMW + JASS index mirrors behind the Stage-0
prediction framework, production scale (50M docs / 2M terms / ~15B
postings across a 256-chip pod).  A copy of ``repro.configs.paper_isn``,
field for field; ``repro_torch.isn.shard`` serves its step over
``torch.distributed``."""

from dataclasses import dataclass

FAMILY = "isn"


@dataclass(frozen=True)
class ISNConfig:
    name: str = "paper-isn"
    n_docs: int = 50_331_648          # 196,608 docs / shard on 16x16
    vocab: int = 2_000_000
    postings_per_shard: int = 58_982_400
    block_entries_per_shard: int = 29_491_200
    n_levels: int = 32
    block_size: int = 64
    k_max: int = 4096
    rho_max: int = 131_072            # per-shard budget (≈ 33.5M global)
    query_len: int = 8
    queries_per_step: int = 4096      # global serve batch
    tile_d: int = 128                 # docs per bucketed serving tile
    tile_cap: int = 65_536            # lane-padded postings capacity / tile


CONFIG = ISNConfig()

REDUCED = ISNConfig(
    name="paper-isn-reduced", n_docs=8192, vocab=4096,
    postings_per_shard=750_000, block_entries_per_shard=350_000,
    n_levels=256, block_size=64, k_max=128, rho_max=4096, query_len=8,
    queries_per_step=32, tile_d=128, tile_cap=16_384,
)
