"""Paper-faithful MLPs (Chen et al. 2015 §6): HashNet + all baselines,
PyTorch port of the JAX package's ``paper/mlp.py``.

Methods, at a common storage budget K^l per layer (counted strictly in
*free parameters*, biases included, exactly as the paper counts):

- ``hashed`` — HashedNets: V[i,j] = xi(i,j) * w[h(i,j)], dedicated hash
  functions per layer (paper Eq. 7), ReLU, dropout on hidden activations.
  The layer runs ``core.hashed.matmul(..., path="pallas")``: the
  hand-written kernels on the card (forward, ``dx`` and ``dw``), their
  plain versions on the CPU.
- ``dense`` — standard fully-connected net (the compression-1 teacher and,
  with shrunk hidden widths, the Equivalent-Size NN baseline).
- ``rer`` — Random Edge Removal (Ciresan et al. 2011): a fixed random
  connectivity mask at density = compression, *recomputed from the hash*
  (cached per spec on the device), so only surviving weights count
  toward storage.
- ``lrd`` — Low-Rank Decomposition (Denil et al. 2013): V = U @ G with G
  fixed Gaussian (std 1/sqrt(n_in)) and U learned, rank chosen to meet
  the budget.  The JAX package regenerates G from ``jax.random`` in every
  forward, which PyTorch cannot reproduce: the port draws G once per
  (spec, layer) from a ``torch.Generator`` seeded with the same derived
  seed (:func:`fixed_factors`) and keeps it beside the params, never
  updated and not counted as storage.  Every function that runs a net
  takes ``fixed=`` to hand in other factors (the reference's, in tests).

Dark Knowledge is a training mode (``repro_torch.paper.train``).

Params are a list of per-layer dicts of fp32 tensors ({"w", "b"}, or
{"u", "b"} for LRD), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import hashed as H
from repro_torch.core import hashing
from repro_torch.core.device import resolve_device
from repro_torch.core.hashing import derive_seed


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    dims: Tuple[int, ...]           # e.g. (784, 1000, 10) for "3 layers"
    method: str = "dense"           # dense | hashed | rer | lrd
    compression: float = 1.0        # storage budget fraction per layer
    dropout: float = 0.3            # hidden-layer dropout (paper trains with)
    input_dropout: float = 0.1
    seed: int = 0

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def layer_budget(self, l: int) -> int:
        """K^l: free weights for layer l under the compression budget."""
        full = self.dims[l] * self.dims[l + 1]
        return max(1, int(round(self.compression * full)))

    def hashed_spec(self, l: int) -> H.HashedSpec:
        return H.HashedSpec(
            virtual_shape=(self.dims[l], self.dims[l + 1]),
            compression=self.layer_budget(l) / (self.dims[l] * self.dims[l + 1]),
            mode="element",
            seed=derive_seed(self.seed, 0xAB, l),   # dedicated h^l per layer
            panel_cols=0,                            # paper: global buckets
        )

    def lrd_rank(self, l: int) -> int:
        """budget = rank * min(n_in, n_out): the *learned* factor sits on
        the smaller side (maximizes rank; otherwise a wide->narrow layer
        degenerates to rank 1 with a fixed output direction)."""
        return max(1, self.layer_budget(l) // min(self.dims[l],
                                                  self.dims[l + 1]))

    def lrd_learn_left(self, l: int) -> bool:
        """True: learn U (n_in, r), fix G (r, n_out); False: the reverse."""
        return self.dims[l] <= self.dims[l + 1]

    def free_params(self) -> int:
        """Stored parameter count (the paper's x-axis)."""
        total = 0
        for l in range(self.n_layers):
            if self.method == "dense":
                total += self.dims[l] * self.dims[l + 1]
            elif self.method == "hashed":
                total += self.hashed_spec(l).num_buckets
            elif self.method == "rer":
                total += self.layer_budget(l)
            elif self.method == "lrd":
                total += self.lrd_rank(l) * min(self.dims[l],
                                                self.dims[l + 1])
            total += self.dims[l + 1]  # bias
        return total


def equivalent_dense_dims(dims: Sequence[int], compression: float
                          ) -> Tuple[int, ...]:
    """The paper's Equivalent-Size NN: shrink every hidden layer by a common
    factor until stored params match the budget (weights + biases)."""
    dims = tuple(dims)
    if len(dims) == 2:
        return dims

    def params_at(h: float) -> float:
        ds = [dims[0]] + [max(1.0, h)] * (len(dims) - 2) + [dims[-1]]
        return sum(ds[i] * ds[i + 1] + ds[i + 1] for i in range(len(ds) - 1))

    target = compression * params_at(dims[1])
    lo, hi = 1.0, float(dims[1])
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if params_at(mid) > target:
            hi = mid
        else:
            lo = mid
    h = max(1, int(round(lo)))
    return (dims[0],) + (h,) * (len(dims) - 2) + (dims[-1],)


# ---------------------------------------------------------------------------
# fixed, non-learned tensors: the RER mask and the LRD factor
# ---------------------------------------------------------------------------

_FIXED: Dict[tuple, torch.Tensor] = {}


def rer_mask(spec: MLPSpec, l: int, device) -> torch.Tensor:
    """Fixed random connectivity mask (fp32 0/1) at density=compression;
    derived from the stateless hash so it is never stored (same trick as
    the paper).  Cached per (spec, layer, device)."""
    key = ("rer", spec, l, str(device))
    if key not in _FIXED:
        i = torch.arange(spec.dims[l], dtype=torch.int64, device=device)
        j = torch.arange(spec.dims[l + 1], dtype=torch.int64, device=device)
        h = hashing.hash_key(i[:, None], j[None, :],
                             derive_seed(spec.seed, 0xE, l))
        # keep edge iff h < compression * 2^32
        thresh = min(0xFFFFFFFF, int(spec.compression * 2.0 ** 32))
        _FIXED[key] = (h < thresh).to(torch.float32)
    return _FIXED[key]


def lrd_fixed_shape(spec: MLPSpec, l: int) -> Tuple[int, int]:
    """(r, n_out) when the left factor is learned, (n_in, r) otherwise."""
    r = spec.lrd_rank(l)
    return ((r, spec.dims[l + 1]) if spec.lrd_learn_left(l)
            else (spec.dims[l], r))


def lrd_fixed(spec: MLPSpec, l: int, device) -> torch.Tensor:
    """Fixed Gaussian factor of :func:`lrd_fixed_shape`, std 1/sqrt(n_in)
    (paper §6).  Drawn on the CPU from a generator seeded with
    ``derive_seed(seed, 0x1d, l)`` (the same values on every device) and
    cached per (spec, layer, device)."""
    key = ("lrd", spec, l, str(device))
    if key not in _FIXED:
        g = torch.Generator().manual_seed(derive_seed(spec.seed, 0x1d, l))
        _FIXED[key] = (torch.randn(lrd_fixed_shape(spec, l), generator=g)
                       / math.sqrt(spec.dims[l])).to(device)
    return _FIXED[key]


def fixed_factors(spec: MLPSpec, device) -> List[Optional[torch.Tensor]]:
    """Per layer: the LRD fixed factor, or None (every other method)."""
    return [lrd_fixed(spec, l, device) if spec.method == "lrd" else None
            for l in range(spec.n_layers)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def param_shapes(spec: MLPSpec) -> List[Dict[str, Tuple[int, ...]]]:
    """Per layer: the shape of each param, as :func:`init` makes them."""
    out = []
    for l in range(spec.n_layers):
        n_in, n_out = spec.dims[l], spec.dims[l + 1]
        if spec.method == "hashed":
            w = ("w", spec.hashed_spec(l).real_param_shape())
        elif spec.method == "lrd":
            r = spec.lrd_rank(l)
            w = ("u", (n_in, r) if spec.lrd_learn_left(l) else (r, n_out))
        else:
            w = ("w", (n_in, n_out))
        out.append(dict([w, ("b", (n_out,))]))
    return out


def init(spec: MLPSpec, generator: torch.Generator,
         device=None) -> List[dict]:
    """Seeded params, drawn from the CPU ``generator`` layer by layer and
    moved to ``device`` (default the card).  The JAX package's
    ``jax.random`` init cannot be reproduced; parity tests carry params
    across instead (``interop.mlp_params_from_numpy``)."""
    dev = resolve_device(device)
    params = []
    for l, shapes in enumerate(param_shapes(spec)):
        n_in = spec.dims[l]
        scale = 1.0 / math.sqrt(n_in)
        if spec.method == "hashed":
            w = H.init(generator, spec.hashed_spec(l), scale=scale)
        elif spec.method == "lrd":
            # Var(V) = r * Var(learned) * Var(fixed) with Var(fixed)=1/n_in;
            # learned ~ N(0, 1/r) keeps the virtual init at the dense scale.
            r = spec.lrd_rank(l)
            w = torch.randn(shapes["u"], generator=generator) \
                / math.sqrt(max(r, 1))
        else:
            w = torch.randn(shapes["w"], generator=generator) * scale
        name = "u" if spec.method == "lrd" else "w"
        params.append({name: w.to(dev),
                       "b": torch.zeros(shapes["b"], device=dev)})
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer(spec: MLPSpec, l: int, p: dict, x: torch.Tensor, fixed,
           path: str) -> torch.Tensor:
    if spec.method == "hashed":
        y = H.matmul(x, p["w"], spec.hashed_spec(l), path=path)
    elif spec.method == "rer":
        y = x @ (p["w"] * rer_mask(spec, l, x.device))
    elif spec.method == "lrd":
        g = fixed[l] if fixed is not None else lrd_fixed(spec, l, x.device)
        if spec.lrd_learn_left(l):
            y = (x @ p["u"]) @ g
        else:
            y = (x @ g) @ p["u"]
    else:
        y = x @ p["w"]
    return y + p["b"]


def _dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return x * mask / keep


def apply(spec: MLPSpec, params: List[dict], x: torch.Tensor,
          generator: Optional[torch.Generator] = None, train: bool = False,
          fixed=None, path: str = "pallas") -> torch.Tensor:
    """x (B, 784) -> logits (B, C).  ReLU + dropout as in the paper; the
    dropout masks come from ``generator`` (on x's device) when ``train``.
    ``fixed``: per-layer LRD factors (default :func:`fixed_factors`);
    ``path``: the hashed layers' matmul path (``"materialize"`` runs the
    plain PyTorch product on any device)."""
    drop = train and generator is not None
    if drop and spec.input_dropout > 0:
        x = _dropout(x, spec.input_dropout, generator)
    for l in range(spec.n_layers):
        x = _layer(spec, l, params[l], x, fixed, path)
        if l < spec.n_layers - 1:
            x = torch.relu(x)
            if drop and spec.dropout > 0:
                x = _dropout(x, spec.dropout, generator)
    return x


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def distill_loss(logits, labels, soft_targets, alpha: float = 0.5,
                 temperature: float = 4.0) -> torch.Tensor:
    """Dark-Knowledge combined objective (paper §6: weighted combination of
    original labels and softened teacher softmax)."""
    hard = xent(logits, labels)
    logp = F.log_softmax(logits.float() / temperature, dim=-1)
    soft = -torch.mean(torch.sum(soft_targets * logp, dim=-1)) \
        * temperature ** 2
    return alpha * hard + (1.0 - alpha) * soft
