# Frozen copy of mlprobs_tpu_torch/align/sector.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Sector-tiled consistency relaxation for families over the dense
tensor's budget.

The dense device path (consistency.relax_dense_rounds) needs the whole
(N, N, Lp, Lp) posterior tensor resident.  A family over that budget is
relaxed by *sectors*, as the reference does on the GPU
(RelaxationSector.cpp:14-60, QuickConsistencyStage.cpp:88-215) and the
JAX package does on the TPU (mlprobs_tpu/align/sector.py):

* Host CSR posteriors are flattened into COO row *panels*: panel I holds
  every ordered cell (i, z), i in pair block I, z in 0..N-1, laid out as
  (b, Lp, N, Lp) = [i, a, z, c] so that the panel is a (b*Lp, N*Lp)
  matrix.
* Per sector (I, J) the two panels are scattered into dense tensors on
  the device (`index_put_` with accumulation; every cell is written
  once), and the z-contraction

      R_ij = self_coef[i,j] * S_ij + z_scale[i,j] * sum_z w_z S_iz @ S_zj

  is ONE product (b*Lp, N*Lp) x (N*Lp, b*Lp): S_zj[b, c] = S_jz[c, b],
  so panel J serves transposed, with no copy.  f32 with TF32 off, as the
  dense path.
* The result is masked to support(S_ij > 0), re-thresholded, and leaves
  the device as the top EXTRACT_TOPK entries of each row, ties to the
  lowest column (the order of the JAX package's `lax.top_k`).
* Each round re-sparsifies before the next (ConsistencyStage.cpp:257).

The same coefficients as relax_dense_rounds serve the plain baseMSA
transform and QuickProbs' weighted accept-all regime.  The stochastic
z-filter is no single product; those families stay on the host path.
The pair-block size b changes the tiling, not the result; the top-k
does change the result.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from msabench.msaref.align import consistency as cons
from msabench.msaref.align.pairwise import topk_to_csr
from msabench.msaref.core.config import engine_budgets
from msabench.msaref.utils import device as devlib

CUTOFF = 0.01
# entries a row that leave the device (the JAX package's
# sector_extract_topk)
EXTRACT_TOPK = 24


class SectorOverBudget(RuntimeError):
    """The sector plan cannot fit the budget at any block size; callers
    demote to the host relaxation before launching anything."""


def _sector_peak_bytes(b: int, n: int, lp: int, k: int) -> int:
    """Peak live device bytes of one sector step at pair-block size b:
    three (b, N, Lp, Lp) panels (i, the weighted j, one transient), three
    (b, b, Lp, Lp) blocks (S_ij, the product, the masked result) and the
    top-k (the JAX package's accounting)."""
    panel = 4 * b * n * lp * lp
    block = 4 * b * b * lp * lp
    topk = 2 * 4 * b * b * lp * k
    return 3 * panel + 3 * block + topk


class SectorRelaxer:
    """Relaxation rounds over host CSR posteriors by device sectors."""

    def __init__(self, lengths: list[int], budget: int | None = None,
                 device="cuda"):
        self.device = devlib.resolve(device)
        self.n = len(lengths)
        self.lengths = lengths
        self.lp = -(-max(128, max(lengths)) // 128) * 128
        budget = int(budget or engine_budgets(self.device.type,
                                              self.device.index)[2])
        self.budget = budget
        self.k = EXTRACT_TOPK
        self.b = 0
        for b in (128, 64, 32, 16, 8, 4, 2, 1):
            if b > self.n and b != 1:
                continue
            if _sector_peak_bytes(b, self.n, self.lp, self.k) <= budget:
                self.b = b
                break
        if self.b == 0:
            raise SectorOverBudget(
                f"sector relaxation cannot fit the budget even at b=1 "
                f"(N={self.n}, Lp={self.lp}, "
                f"peak={_sector_peak_bytes(1, self.n, self.lp, self.k):.2e}"
                f" > budget={budget:.2e})"
            )
        self.nblocks = -(-self.n // self.b)
        self.peak_bytes = _sector_peak_bytes(self.b, self.n, self.lp, self.k)

    # -------------------------------------------------------------- panels
    def _panel_coo(self, posts, blk: int):
        """COO (linear index, value) of panel `blk` from the current CSRs."""
        i0 = blk * self.b
        lin_l, vals_l = [], []
        n, lp = self.n, self.lp
        for di in range(min(self.b, n - i0)):
            i = i0 + di
            for z in range(n):
                if z == i:
                    continue
                key = (i, z) if i < z else (z, i)
                s = posts.get(key)
                if s is None or s.nnz == 0:
                    continue
                coo = s.tocoo()
                r, c = (coo.row, coo.col) if i < z else (coo.col, coo.row)
                lin = ((di * lp + r.astype(np.int64)) * n + z) * lp + c
                lin_l.append(lin)
                vals_l.append(coo.data.astype(np.float32))
        if not lin_l:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        return np.concatenate(lin_l), np.concatenate(vals_l)

    def _densify(self, posts, blk: int, w: np.ndarray | None):
        """Panel `blk` as a dense (b, Lp, N, Lp) tensor on the device,
        entry (di, a, z, c) times w[z] when `w` is given."""
        lin, vals = self._panel_coo(posts, blk)
        if w is not None:
            z = (lin // self.lp) % self.n
            vals = vals * w[z].astype(np.float32)
        dev = self.device
        flat = torch.zeros(self.b * self.lp * self.n * self.lp,
                           dtype=torch.float32, device=dev)
        flat.index_put_((torch.from_numpy(lin).to(dev),),
                        torch.from_numpy(vals).to(dev), accumulate=True)
        return flat.view(self.b, self.lp, self.n, self.lp)

    def _sector(self, panel_i, panel_j_w, j0, scb, zsb, cutoff):
        """(vals, idx) (b, b, Lp, k): the relaxed sector's row top-k."""
        b, lp, n, k = self.b, self.lp, self.n, self.k
        prod = (panel_i.view(b * lp, n * lp)
                @ panel_j_w.view(b * lp, n * lp).T).view(b, lp, b, lp)
        s_ij = panel_i[:, :, j0:j0 + b, :]
        if s_ij.shape[2] < b:
            s_ij = torch.nn.functional.pad(s_ij,
                                           (0, 0, 0, b - s_ij.shape[2]))
        r = prod.mul_(zsb[:, None, :, None]).add_(scb[:, None, :, None] * s_ij)
        r = torch.where((s_ij > 0) & (r >= cutoff), r, 0.0)
        del prod, s_ij
        vals, idx = torch.sort(r, dim=-1, descending=True, stable=True)
        vals = vals[..., :k].permute(0, 2, 1, 3)
        idx = idx[..., :k].permute(0, 2, 1, 3)
        return vals, idx

    # -------------------------------------------------------------- rounds
    def relax(
        self,
        posts: dict[tuple[int, int], sp.csr_matrix],
        self_coef: np.ndarray,
        z_scale: np.ndarray,
        w: np.ndarray,
        reps: int = 2,
        cutoff: float = CUTOFF,
        final_cutoff: float | None = None,
    ) -> dict[tuple[int, int], sp.csr_matrix]:
        torch.backends.cuda.matmul.allow_tf32 = False
        n, b = self.n, self.b
        dev = self.device
        sc = np.asarray(self_coef, np.float32)
        zs = np.asarray(z_scale, np.float32)
        w = np.asarray(w, np.float32)
        w_dev = torch.from_numpy(w).to(dev)
        uniform_w = bool(np.all(w == w[0]))
        for it in range(reps):
            # numFilterings=-1: the last round re-sparsifies at 1e-5
            # (ConsistencyStage.cpp:230-259)
            round_cutoff = (cutoff if (final_cutoff is None
                                       or it < reps - 1)
                            else final_cutoff)
            new: dict[tuple[int, int], sp.csr_matrix] = {}
            for bi in range(self.nblocks):
                panel_i = self._densify(posts, bi, None)
                for bj in range(bi, self.nblocks):
                    if bj == bi:
                        panel_j_w = (panel_i * float(w[0]) if uniform_w
                                     else panel_i * w_dev[None, None, :,
                                                          None])
                    else:
                        panel_j_w = self._densify(posts, bj, w)
                    i0, j0 = bi * b, bj * b
                    scb = torch.from_numpy(_block(sc, i0, j0, b)).to(dev)
                    zsb = torch.from_numpy(_block(zs, i0, j0, b)).to(dev)
                    vals, idx = self._sector(panel_i, panel_j_w, j0, scb,
                                             zsb, round_cutoff)
                    del panel_j_w
                    vals = vals.cpu().numpy()
                    idx = idx.cpu().numpy()
                    for di in range(min(b, n - i0)):
                        i = i0 + di
                        for dj in range(min(b, n - j0)):
                            j = j0 + dj
                            if j <= i or (i, j) not in posts:
                                continue
                            li, lj = self.lengths[i], self.lengths[j]
                            new[(i, j)] = topk_to_csr(
                                vals[di, dj], idx[di, dj], li, lj
                            )
                del panel_i
            posts = new
        return posts


def _block(m: np.ndarray, i0: int, j0: int, b: int) -> np.ndarray:
    out = np.zeros((b, b), m.dtype)
    blk = m[i0: i0 + b, j0: j0 + b]
    out[: blk.shape[0], : blk.shape[1]] = blk
    return out


def relax_sector_device(
    posts: dict[tuple[int, int], sp.csr_matrix],
    lengths: list[int],
    reps: int = 2,
    cutoff: float = CUTOFF,
    weights: np.ndarray | None = None,
    selfweight: float = 3.0,
    selectivity: float = 200.0,
    final_cutoff: float | None = None,
    device="cuda",
    budget: int | None = None,
    report: dict | None = None,
) -> dict[tuple[int, int], sp.csr_matrix]:
    """Sector-tiled relaxation with the dense path's coefficients
    (consistency.dense_relax_coeffs): weights=None is the plain baseMSA
    transform, else QuickProbs' weighted accept-all.  `report`, when
    given, records the block size, the sector count and the predicted
    peak bytes."""
    n = len(lengths)
    sc, zs, w = cons.dense_relax_coeffs(
        n, weights, selfweight=selfweight, selectivity=selectivity
    )
    rl = SectorRelaxer(lengths, budget=budget, device=device)
    if report is not None:
        report["sector"] = {
            "b": rl.b, "blocks": rl.nblocks,
            "sectors": rl.nblocks * (rl.nblocks + 1) // 2 * reps,
            "predicted_peak_bytes": rl.peak_bytes, "budget": rl.budget,
        }
    return rl.relax(posts, sc, zs, w, reps=reps, cutoff=cutoff,
                    final_cutoff=final_cutoff)
