"""App base: module registry and the degree-sort relabel.

Counterpart of `graphlily_tpu/apps/module_collection.py`.
"""
from __future__ import annotations

import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..io.formatter import symmetric_permute, degree_sort_permutation


class ModuleCollection:
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG):
        self.config = config
        self.device = config.resolve_device()
        self.modules_ = []
        # vertex relabeling (config.sort_rows_by_degree): apps run in the
        # relabeled space; these translate at the API boundary
        self.vertex_perm_ = None   # new i = old perm[i]
        self.vertex_inv_ = None    # position of old vertex o

    def add_module(self, module) -> None:
        self.modules_.append(module)

    def _maybe_relabel(self, csr):
        """Apply the symmetric degree-sort relabeling if configured."""
        if not self.config.sort_rows_by_degree:
            return csr
        perm = degree_sort_permutation(csr)
        self.vertex_perm_ = perm
        self.vertex_inv_ = np.empty_like(perm)
        self.vertex_inv_[perm] = np.arange(len(perm))
        return symmetric_permute(csr, perm)

    def _internal_source(self, source: int) -> int:
        return int(self.vertex_inv_[source]) if self.vertex_inv_ is not None \
            else source

    def _external(self, y: np.ndarray) -> np.ndarray:
        """Un-relabel a dense result (padding rows stay at the tail)."""
        if self.vertex_perm_ is None:
            return y
        out = y.copy()
        n = len(self.vertex_perm_)
        out[: n][self.vertex_perm_] = y[: n]
        return out

    def set_up_runtime(self, *_a, **_k) -> None:
        """API-parity no-op."""
        return None
