"""Architecture registry: ``--arch <id>`` resolution.

Lists every architecture the JAX package's registry lists, each with
the port's own config module: the five LM archs (``llama3.2-3b``,
``gemma2-9b``, ``gemma3-27b``, the MoE ``qwen3-moe-30b-a3b`` and the
MLA + MoE ``deepseek-v2-lite-16b``), the GNN ``mace``, the four recsys
archs (``dlrm-rm2``, ``dlrm-mlperf``, ``deepfm``, ``autoint``) and the
retrieval config ``ragdb``.  ``cells()`` lists every (arch, shape) cell,
as the JAX package's does.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | ragdb
    module: str

    @property
    def config(self):
        return importlib.import_module(self.module).FULL

    @property
    def smoke_config(self):
        return importlib.import_module(self.module).SMOKE


ARCHS: dict[str, ArchSpec] = {
    "gemma3-27b": ArchSpec("gemma3-27b", "lm",
                           "repro_torch.configs.gemma3_27b"),
    "gemma2-9b": ArchSpec("gemma2-9b", "lm", "repro_torch.configs.gemma2_9b"),
    "llama3.2-3b": ArchSpec("llama3.2-3b", "lm",
                            "repro_torch.configs.llama3_2_3b"),
    "qwen3-moe-30b-a3b": ArchSpec("qwen3-moe-30b-a3b", "lm",
                                  "repro_torch.configs.qwen3_moe_30b_a3b"),
    "deepseek-v2-lite-16b": ArchSpec(
        "deepseek-v2-lite-16b", "lm",
        "repro_torch.configs.deepseek_v2_lite_16b"),
    "mace": ArchSpec("mace", "gnn", "repro_torch.configs.mace"),
    "dlrm-rm2": ArchSpec("dlrm-rm2", "recsys",
                         "repro_torch.configs.dlrm_rm2"),
    "deepfm": ArchSpec("deepfm", "recsys", "repro_torch.configs.deepfm"),
    "dlrm-mlperf": ArchSpec("dlrm-mlperf", "recsys",
                            "repro_torch.configs.dlrm_mlperf"),
    "autoint": ArchSpec("autoint", "recsys", "repro_torch.configs.autoint"),
    "ragdb": ArchSpec("ragdb", "ragdb", "repro_torch.configs.ragdb"),
}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}"
        )
    return ARCHS[arch_id]


def cells() -> list[tuple[str, str]]:
    """All (arch_id, shape_id) cells, in the JAX package's order."""
    from repro_torch.configs import shapes as shp

    return [(arch_id, shape_id) for arch_id, spec in ARCHS.items()
            for shape_id in shp.shapes_for_family(spec.family)]
