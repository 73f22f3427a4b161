"""The paper's own model configurations (Sec. VI-A): GCN / GIN / GIN+VN /
GAT / PNA / DGN with the published layer counts and widths."""

from repro_torch.core.models import PAPER_GNN_CONFIGS as CONFIGS

__all__ = ["CONFIGS"]
