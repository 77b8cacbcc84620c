"""Sharded pipeline stages over a pairs mesh (parallel/mesh.py).

The counterparts of the JAX package's `parallel/sharded.py`:
`make_sharded_posterior_step` is the posterior stage with the batch of
pairs split over the mesh (pure data parallelism: each device runs the
two kernels, or their plain versions on the CPU, on its own pairs), and
`make_sharded_consistency` one dense consistency round with the rows of
the pair matrix split over the mesh: each device holds its block of rows
and a gathered copy of the whole tensor, and contracts its block.

The sharded round is the single-device round of
`align/consistency.relax_dense_rounds`, row block by row block: it
masks to the round's input support (S > 0) and re-thresholds at the
cutoff it is given, so the last round can take the realigner's
`final_cutoff`.  The JAX package's sharded round re-thresholds every
round at a fixed 0.01 and masks with S >= cutoff, so there a family's
MSA depends on the number of chips (ROADMAP.md, faults on the reference
side); here it does not.
"""
from __future__ import annotations

import torch

from mlprobs_tpu_torch.align import pairwise
from mlprobs_tpu_torch.ops import wavefront
from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk
from mlprobs_tpu_torch.parallel.mesh import PairsMesh, gather, split_pairs

_MODELS = ("hmm5", "partition", "local")


def make_sharded_posterior_step(mesh: PairsMesh):
    """(X, Y, LX, LY) -> (posteriors (B, Lp, Lp), scores (B,)), the pair
    axis split over `mesh`, the outputs on X's device.

    X/Y: (B, Lp) int8; each device runs the mix-mode posterior stage
    (hmm5, partition and local, RMS-combined, the MWT score) on its
    share of the pairs.  Posteriors are returned unskewed: grid cell
    (i, j) is the posterior of residues i + 1 and j + 1.
    """

    def local_step(x, y, lx, ly):
        b, lp = x.shape
        # the wavefront's contract is PAD beyond each true length: the
        # local model's emissions are not masked by bounds, so other
        # values in the pad region would leak posterior mass
        col = torch.arange(lp, device=x.device)[None, :]
        x = torch.where(col < lx[:, None], x, wavefront.PAD).to(x.dtype)
        y = torch.where(col < ly[:, None], y, wavefront.PAD).to(y.dtype)
        tabs_f, tabs_r = pairwise._wf_tables("mix", None, x.device)
        post, score = wk.posterior(x, y, lx, ly, tabs_f, tabs_r,
                                   models=_MODELS)
        return wavefront.unskew_posterior(post).contiguous(), score

    def step(X, Y, LX, LY):
        outs = [local_step(*shard)
                for _, shard in split_pairs((X, Y, LX, LY), mesh)]
        return gather(outs, (0, 0), X.device)

    return step


def split_rows(S: torch.Tensor, mesh: PairsMesh) -> list:
    """The row blocks of a (N, N, Lp, Lp) tensor, each on its device."""
    return [shard[0] for _, shard in split_pairs((S,), mesh)]


def gather_rows(blocks, device) -> torch.Tensor:
    """The (N, N, Lp, Lp) tensor of `split_rows`'s blocks on `device`."""
    return gather([(b,) for b in blocks], (0,), device)[0]


def make_sharded_consistency(mesh: PairsMesh, num_seqs: int,
                             cutoff: float = pairwise.CUTOFF):
    """One consistency round over row blocks of a zero-diagonal
    (N, N, Lp, Lp) posterior tensor, N = `num_seqs` a multiple of the
    mesh size.

    Returns `relax(blocks, self_coef, z_scale, w, cutoff=cutoff)`:
    `blocks` are the mesh devices' row blocks (`split_rows`), the
    coefficients those of `consistency.dense_relax_coeffs` as tensors
    ((N, N), (N, N), (N,)).  Block k of the result is
    R = sc * S + zs * sum_z w_z S_iz S_zj over its rows, masked to the
    block's support and thresholded at the round's cutoff.  The
    contraction runs in f32 with TF32 off, as the single-device round.
    """
    if num_seqs % mesh.size:
        raise ValueError(f"{num_seqs} rows do not split over a mesh of "
                         f"{mesh.size}; pad them with zero rows")
    rows = num_seqs // mesh.size

    def relax(blocks, self_coef, z_scale, w, cutoff=cutoff):
        torch.backends.cuda.matmul.allow_tf32 = False
        out = []
        for k, (dev, blk) in enumerate(zip(mesh.devices, blocks)):
            # the all-gather: every block of the round's input on dev
            s_all = torch.cat([b.to(dev) for b in blocks])
            sl = slice(k * rows, (k + 1) * rows)
            sc = self_coef[sl].to(dev)[:, :, None, None]
            zs = z_scale[sl].to(dev)[:, :, None, None]
            prod = torch.einsum("izab,z,zjbc->ijac", blk, w.to(dev), s_all)
            del s_all
            r = sc * blk + zs * prod
            del prod
            out.append(torch.where((blk > 0) & (r >= cutoff), r, 0.0))
        return out

    return relax
