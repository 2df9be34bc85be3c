"""tpunmf — a non-negative matrix factorization engine on JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the reference
package (raleng/nmf): MUR, ANLS (batched active-set / BPP NNLS), ADMM and
AO-ADMM solvers, Euclidean and Kullback-Leibler objectives, proximal
regularizers, NNDSVD initialization, and reference-compatible persistence —
plus multi-device sharding, fused Pallas kernels, checkpoint/resume, and a
top-k retrieval serving path that the reference does not have.

Public surface mirrors the reference (`from nmf import NMF`,
reference: nmf/__init__.py:1):

    >>> from tpunmf import NMF
    >>> model = NMF(data, factors)
    >>> model.factorize(method="mur", distance_type="eu")
    >>> model.w, model.h
"""
from .api import NMF

__version__ = "0.1.0"
__all__ = ["NMF"]
