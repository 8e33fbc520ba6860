"""mace [arXiv:2206.07697]: 2 layers, d_hidden 128, l_max 2,
correlation order 3, 8 radial basis functions, E(3)-equivariant.
The same values as the JAX package's ``configs/mace.py``.

d_feat varies per shape (the graph shapes carry their own feature
widths); the config pins the architecture, the cell pins d_feat.
"""
from repro_torch.models.gnn.mace import MACEConfig

FULL = MACEConfig(
    name="mace",
    n_layers=2,
    d_hidden=128,
    l_max=2,
    correlation_order=3,
    n_rbf=8,
    d_feat=128,  # replaced per shape via dataclasses.replace
    n_classes=64,
)

SMOKE = MACEConfig(
    name="mace-smoke",
    n_layers=2,
    d_hidden=32,
    l_max=2,
    correlation_order=3,
    n_rbf=8,
    d_feat=16,
    n_classes=8,
)
