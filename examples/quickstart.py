"""tpunmf quickstart: factorize, inspect, serve.

Run:  python examples/quickstart.py          (CPU or GPU)
"""
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from tpunmf import NMF
from tpunmf.data import movielens_like
from tpunmf.serve import topk_scores_dense

# a small recommender-style matrix (synthetic MovieLens stand-in)
ratings = movielens_like(600, 370, density=0.15, seed=0)

model = NMF(ratings, factors=32)
model.factorize(method="anls", min_iter=5, max_iter=50, tol1=1e-5, tol2=1e-5)
print(f"converged after {model.results.i + 1} iterations; "
      f"objective {model.results.obj_history[0]:.1f} -> "
      f"{model.results.obj_history[-1]:.2f}")

rel = np.linalg.norm(ratings - model.w @ model.h) / np.linalg.norm(ratings)
print(f"relative reconstruction error: {rel:.3f}")

# top-5 recommendations for the first 3 users
vals, items = topk_scores_dense(model.w[:3], model.h, 5)
for u, row in enumerate(np.asarray(items)):
    print(f"user {u}: recommend items {list(map(int, row))}")

model.save_factorization(save_dir="/tmp/tpunmf-quickstart")
