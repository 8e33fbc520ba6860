"""Architecture registry: ``--arch <id>`` resolution.

Lists every architecture the JAX package's registry lists.  Ported:
``llama3.2-3b`` and the four recsys archs (``dlrm-rm2``, ``dlrm-mlperf``,
``deepfm``, ``autoint``); ``get`` raises ``NotImplementedError`` for the
others, naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | ragdb
    module: str | None  # None until the arch is ported
    roadmap: str = ""   # the ROADMAP item that ports it

    @property
    def config(self):
        return importlib.import_module(self.module).FULL

    @property
    def smoke_config(self):
        return importlib.import_module(self.module).SMOKE


_LM_LATER = "ROADMAP Queue 1 item 10 (training and generation substrate)"
_GNN = "ROADMAP Queue 1 item 11 (GNN: models/gnn/{mace,sampler}.py)"

ARCHS: dict[str, ArchSpec] = {
    "gemma3-27b": ArchSpec("gemma3-27b", "lm", None, _LM_LATER),
    "gemma2-9b": ArchSpec("gemma2-9b", "lm", None, _LM_LATER),
    "llama3.2-3b": ArchSpec("llama3.2-3b", "lm",
                            "repro_torch.configs.llama3_2_3b"),
    "qwen3-moe-30b-a3b": ArchSpec("qwen3-moe-30b-a3b", "lm", None,
                                  _LM_LATER),
    "deepseek-v2-lite-16b": ArchSpec("deepseek-v2-lite-16b", "lm", None,
                                     _LM_LATER),
    "mace": ArchSpec("mace", "gnn", None, _GNN),
    "dlrm-rm2": ArchSpec("dlrm-rm2", "recsys",
                         "repro_torch.configs.dlrm_rm2"),
    "deepfm": ArchSpec("deepfm", "recsys", "repro_torch.configs.deepfm"),
    "dlrm-mlperf": ArchSpec("dlrm-mlperf", "recsys",
                            "repro_torch.configs.dlrm_mlperf"),
    "autoint": ArchSpec("autoint", "recsys", "repro_torch.configs.autoint"),
    "ragdb": ArchSpec("ragdb", "ragdb", None, _LM_LATER),
}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}"
        )
    spec = ARCHS[arch_id]
    if spec.module is None:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to PyTorch yet; it comes "
            f"with {spec.roadmap}")
    return spec
