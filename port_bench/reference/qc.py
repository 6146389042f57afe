"""Quasi-cyclic LDPC codes of the benchmark, worked out from the matrix
prototype in their configuration file alone.

A prototype is a table of shifts: entry p >= 0 stands for the Z x Z
identity with its columns cyclically shifted right by p (row i has its one
in column (i + p) mod Z), -1 for the Z x Z zero block. The configuration
gives Z, the prototype and the order in which its block columns are laid
out. The expanded H then goes through the reference encoder's column
reordering and parity operator of ``code.py``, as a published H does, and
gives a ``code.Code`` that ``sweep.py`` draws with.

``decode`` is ``sweep.py``'s min-sum and sum-product with the variable side
laid out for codes with a few heavy columns. ``sweep.py`` pads every
variable to the largest column weight and sums the var-major slots in
strided steps; here a variable's messages lie in a block of the variables
of its degree, slot after slot, so each step of a sum reads a contiguous
slice. The sums are the same, in the same order, so the decisions and the
passes are ``sweep.py``'s bit for bit:

* a decision adds the variable's slots from slot 0 up; ``sweep.py`` then
  adds its zero pads, of which only the first can change anything (it
  turns a -0.0 into +0.0), so it is added once;
* a sum of the other slots starts from +0.0, which no later add in
  round-to-nearest turns into -0.0, so its zero pads change nothing; the
  sum for slot k shares its first k adds with every later slot's, so that
  prefix is carried over rather than redone.

The check side is ``sweep.py``'s, line for line, on the same tensors.

Plain NumPy and PyTorch; imports nothing of the program under test.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from . import sweep
from .code import Code, _gf2_inverse, _padded, _reorder

__all__ = ["expand", "code_of", "load_config_code", "decode"]


def expand(proto, Z: int, order) -> np.ndarray:
    """The 0/1 uint8 H (rows * Z, cols * Z) of a prototype of shifts, block
    column c of H being the prototype's column order[c]."""
    proto = np.asarray(proto, np.int64)
    rows, cols = proto.shape
    if sorted(order) != list(range(cols)):
        raise ValueError("the column order must permute the block columns")
    H = np.zeros((rows * Z, cols * Z), np.uint8)
    for b in range(rows):
        for c, src in enumerate(order):
            p = int(proto[b, src])
            if p < 0:
                continue
            if p >= Z:
                raise ValueError(f"shift {p} is not below Z = {Z}")
            for i in range(Z):
                H[b * Z + i, c * Z + (i + p) % Z] = 1
    return H


def code_of(name: str, H: np.ndarray) -> Code:
    """The reference's code of a parity-check matrix: H reordered as the
    reference encoder does, the check-bit operator, the neighbour tables."""
    M, N = H.shape
    Hp = _reorder(H)
    G = (_gf2_inverse(Hp[:, :M]).astype(np.int64) @ Hp[:, M:]) % 2
    if ((Hp.astype(np.int64) @ np.concatenate([G, np.eye(N - M, dtype=np.int64)]))
            % 2).any():
        raise AssertionError(f"{name}: the check-bit operator misses H")
    return Code(name, Hp, G.astype(np.uint8), _padded(Hp, 1, N),
                _padded(Hp, 0, M))


_CODES: dict = {}


def load_config_code(config: dict) -> Code:
    """The code of a configuration (its ``code``, ``Z``, ``prototype`` and
    ``column_order``), built once a process."""
    key = json.dumps([config[k] for k in ("code", "Z", "prototype",
                                          "column_order")])
    if key not in _CODES:
        _CODES[key] = code_of(config["code"],
                              expand(config["prototype"], config["Z"],
                                     config["column_order"]))
    return _CODES[key]


class _Edges:
    """The code's edges by variable: the variables of each degree d, and
    their messages as a (d, n) block of slots, the blocks one after another
    over the E edges. ``cm`` is each edge's check-major slot, ``var`` its
    variable, ``back`` each check-major slot's edge (pads: E, a zero)."""

    def __init__(self, code: Code, device: torch.device):
        M, N = code.M, code.N
        g = sweep._graph(code, device)
        vslot = g.vslot.cpu().numpy()
        deg = (code.var < M).sum(1)
        cm, var, self.groups = [], [], []
        for d in np.unique(deg):
            vs = np.flatnonzero(deg == d)
            self.groups.append((int(d), len(cm),
                                torch.as_tensor(vs, device=device)))
            for w in range(d):
                cm += vslot[vs, w].tolist()
                var += vs.tolist()
        self.E, self.Wc = len(cm), code.var.shape[1]
        back = np.full(M * code.chk.shape[1], self.E, np.int64)
        back[cm] = np.arange(self.E)
        self.cm = torch.as_tensor(cm, device=device)
        self.var = torch.as_tensor(var, device=device)
        self.back = torch.as_tensor(back, device=device)

    def blocks(self, x: torch.Tensor):
        """(degree, its variables, its (B, d, n) block of x (B, E))."""
        for d, start, vs in self.groups:
            n = vs.numel()
            yield d, vs, x[:, start:start + d * n].view(x.shape[0], d, n)

    def to_edges(self, x_cm: torch.Tensor, g) -> torch.Tensor:
        """Check-major messages (B, M, Wr) -> (B, E)."""
        return torch.where(g.cmask, x_cm, 0).reshape(x_cm.shape[0], -1)[
            :, self.cm]

    def to_chk(self, x: torch.Tensor, g) -> torch.Tensor:
        """(B, E) -> check-major (B, M, Wr), pads 0."""
        flat = torch.cat([x, x.new_zeros(x.shape[0], 1)], 1)
        return torch.where(g.cmask,
                           flat[:, self.back].view(x.shape[0], *g.cmask.shape),
                           0)

    def total(self, x: torch.Tensor, N: int) -> torch.Tensor:
        """Each variable's slots summed from slot 0 up, (B, N)."""
        out = x.new_empty(x.shape[0], N)
        for d, vs, blk in self.blocks(x):
            acc = blk[:, 0] if d else blk.new_zeros(blk.shape[0], blk.shape[2])
            for i in range(1, d):
                acc = acc + blk[:, i]
            if d < self.Wc:
                acc = acc + 0.0
            out[:, vs] = acc
        return out

    def others(self, x: torch.Tensor) -> torch.Tensor:
        """For each slot the sum of the variable's other slots, in slot
        order from +0.0, (B, E)."""
        parts = []
        for d, _, blk in self.blocks(x):
            prefix = blk.new_zeros(blk.shape[0], blk.shape[2]) if d else None
            for k in range(d):
                acc = prefix
                for i in range(k + 1, d):
                    acc = acc + blk[:, i]
                parts.append(acc)
                if k + 1 < d:
                    prefix = prefix + blk[:, k]
        return torch.cat(parts, 1)


@functools.lru_cache(maxsize=None)
def _edges(code: Code, device: torch.device) -> _Edges:
    return _Edges(code, device)


def _minsum_pass(Lq, Lci, g, e: _Edges):
    big = torch.tensor(float("inf"), dtype=Lq.dtype, device=Lq.device)
    beta = torch.where(g.cmask, Lq.abs(), big)
    alpha = torch.where(g.cmask, sweep._sign(Lq), torch.ones_like(Lq))
    min1, arg = beta.min(-1, keepdim=True)
    slots = torch.arange(beta.shape[-1], device=beta.device)
    is_arg = slots == arg
    min2 = torch.where(is_arg, big, beta).amin(-1, keepdim=True)
    Lr = alpha.prod(-1, keepdim=True) * alpha * torch.where(is_arg, min2, min1)
    Lr_e = e.to_edges(Lr, g)
    LQ = Lci + e.total(Lr_e, Lci.shape[1])
    return e.to_chk(LQ[:, e.var] - Lr_e, g), (LQ < 0).to(torch.int8)


def _sumproduct_pass(Mm, r, g, e: _Edges):
    one = torch.ones_like(Mm)
    th = torch.where(g.cmask, torch.tanh(Mm / 2), one)
    W = th.shape[-1]
    T = torch.stack([torch.prod(torch.cat([th[..., :k], th[..., k + 1:]], -1),
                                -1) for k in range(W)], -1)
    E = torch.log((1 + T) / (1 - T))
    terms = e.to_edges(E, g) + r[:, e.var]
    vhat = (e.total(terms, r.shape[1]) <= 0).to(torch.int8)
    return terms, vhat


def decode(method: str, rx: torch.Tensor, code: Code, iterations: int,
           early_exit: bool = True, dtype=torch.float32):
    """``sweep.decode``, bit for bit: (decisions (B, N) int8, passes run a
    frame (B,) int64)."""
    if method not in ("minsum", "sumproduct"):
        return sweep.decode(method, rx, code, iterations, early_exit, dtype)
    B = rx.shape[0]
    dev = rx.device
    passes = torch.full((B,), iterations, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = None

    def settle(n, v, guard):
        nonlocal done, out
        out = v if out is None else torch.where(done[:, None], out, v)
        if early_exit and (not guard or n + 1 < iterations):
            ok = sweep.syndrome_ok(v, code) & ~done
            passes[ok] = n + 1
            done = done | ok

    g, e = sweep._graph(code, dev), _edges(code, dev)
    r = -rx.to(dtype)
    msg = g.gather(r)
    for n in range(iterations):
        if method == "minsum":
            new, v = _minsum_pass(msg, r, g, e)
            msg = torch.where(done[:, None, None], msg, new)
            settle(n, v, guard=True)
        else:
            terms, v = _sumproduct_pass(msg, r, g, e)
            settle(n, v, guard=False)
            new = e.to_chk(e.others(terms), g)
            msg = torch.where(done[:, None, None], msg, new)
    return out, passes
