"""What the entries share: seeds, weights made on the device, the record of
a call's random draws, and the comparisons that decide ``correct``.

Nothing here imports the port: the entries hand its objects in.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode

Path_ = Tuple  # a leaf's path in a nested params tree: keys and list indices


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run ``seed``: streams of one
    run are independent, and any whole ``seed`` is taken as it is."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


# -- nested params ----------------------------------------------------------

def leaves(tree, prefix: Path_ = ()) -> List[Tuple[Path_, torch.Tensor]]:
    """(path, tensor) of every leaf of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def path_name(path: Path_) -> str:
    return "/".join(str(p) for p in path)


def build_tree(spec: Sequence[Tuple[Path_, tuple, str, float]], tensors) -> dict:
    """The nested dict/list tree of ``tensors`` at the paths of ``spec``
    (list indices in order)."""
    root: dict = {}
    for (path, *_), t in zip(spec, tensors):
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            fresh = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                if key == len(node):
                    node.append(fresh)
            elif key not in node:
                node[key] = fresh
            node = node[key]
        if isinstance(node, list):
            node.append(t)
        else:
            node[path[-1]] = t
    return root


def make_weights(spec, seed: int, device):
    """Weights of a ``spec`` ([(path, shape, kind, scale)], kind ``uniform``
    for U(-scale, scale) or ``normal`` for N(0, scale^2)) made on ``device``
    from ``seed`` in two large draws.  Returns (the program's tree, whose
    leaves are views of one buffer, and the reference's own copy)."""
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    gen = generator(seed, "weights", device)
    parts = list(flat.split(sizes))
    uni = [i for i, s in enumerate(spec) if s[2] == "uniform"]
    nor = [i for i, s in enumerate(spec) if s[2] == "normal"]
    for idx, draw in ((uni, lambda t: t.uniform_(-1.0, 1.0, generator=gen)),
                      (nor, lambda t: t.normal_(0.0, 1.0, generator=gen))):
        if idx:
            block = torch.empty(sum(sizes[i] for i in idx), device=device)
            draw(block)
            for i, piece in zip(idx, block.split([sizes[i] for i in idx])):
                parts[i].copy_(piece).mul_(spec[i][3])
    tensors = [p.view(shape) for p, (_, shape, _, _) in zip(parts, spec)]
    ref = [t.clone() for t in tensors]
    return build_tree(spec, tensors), build_tree(spec, ref)


def to_host(tree):
    return [(p, t.detach().to("cpu", copy=True)) for p, t in leaves(tree)]


# -- the training checks ---------------------------------------------------

# one-step calls of the window's entry that set-up drives and the reference follows
CHECK_STEPS = 3


def optimizer_moment(opt_state):
    """The first moment-like state (a NamedTuple field ``m``) of a chain's
    state: rmsprop's running mean of g^2, adam's first moment."""
    todo = [opt_state]
    while todo:
        x = todo.pop(0)
        if hasattr(x, "_fields") and "m" in x._fields:
            return x.m
        if isinstance(x, (tuple, list)):
            todo.extend(x)
    raise ValueError("no optimizer moment found in the state")


# -- the random draws of a call ---------------------------------------------

class DrawRecorder(TorchFunctionMode):
    """Records what a call draws at random through torch: ``torch.randint``
    outputs (sampled indices) in ``ints`` and ``torch.rand`` outputs (the
    uniforms that dropout compares with its keep rate) in ``uniforms``, in
    the order drawn.  The call's results are unchanged."""

    def __init__(self):
        super().__init__()
        self.ints: List[torch.Tensor] = []
        self.uniforms: List[torch.Tensor] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.randint:
            self.ints.append(out.detach().clone())
        elif func is torch.rand:
            self.uniforms.append(out.detach().clone())
        return out


def fill_slots(slots: Sequence[Tuple[str, tuple]], draws: Sequence[torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Assign a call's draws to the reference's named ``slots`` by shape,
    not by the program's order of drawing: a draw fills the first empty
    slot of its own shape; else the next row of a slot one axis larger
    (a mask drawn step by step: T draws of (N, H) fill a (T, N, H) slot);
    else, drawn at once, the next draws.shape[0] slots of its row's shape.
    Among slots of one shape the draws fill them in the order drawn.
    Raises ValueError when a draw fits no slot or a slot stays empty."""
    rows: Dict[str, list] = {name: [] for name, _ in slots}
    for d in draws:
        shape = tuple(d.shape)
        exact = [n for n, s in slots if s == shape and not rows[n]]
        if exact:
            rows[exact[0]] = [d]
            continue
        stacked = [n for n, s in slots if s[1:] == shape and len(rows[n]) < s[0]
                   and not (rows[n] and tuple(rows[n][0].shape) == s)]
        if stacked:
            rows[stacked[0]].append(d)
            continue
        split = [n for n, s in slots if s == shape[1:] and not rows[n]]
        if len(split) >= shape[0]:
            for n, piece in zip(split, d):
                rows[n] = [piece]
            continue
        raise ValueError(f"a draw of shape {shape} fits no slot of {list(slots)}")
    out = {}
    for name, shape in slots:
        got = rows[name]
        if len(got) == 1 and tuple(got[0].shape) == shape:
            out[name] = got[0]
        elif got and len(got) == shape[0]:
            out[name] = torch.stack(got)
        else:
            raise ValueError(f"slot {name} {shape} was not drawn in full")
    return out


# -- the numbers compared ---------------------------------------------------

def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|: the program's number ``a`` against the reference's ``b``."""
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == 0 else math.inf)


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median leaf's
    (some gradients are all but zero).  ``keep``: the leaves that count."""
    names = [n for n in ref if keep is None or n in keep]
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


def leaf_norms(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in named.items()}


def moving_leaves(ref_grad_norms: Dict[str, float]) -> set:
    """The leaves whose reference gradient is above a thousandth of the
    median leaf's; the others move by round-off alone under adaptive
    optimizers and are left out of the change compared."""
    median = statistics.median(ref_grad_norms.values())
    return {n for n, v in ref_grad_norms.items() if v >= 1e-3 * median}


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The training comparison: each of the first steps' loss, the first
    gradient as the optimizer gets it (per-leaf norms), and the parameters'
    change over the steps (per-leaf norms), program against reference."""
    keep = moving_leaves(ref["grad1"])
    return {
        "loss": max(rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad1": worst_leaf_gap(prog["grad1"], ref["grad1"]),
        "change3": worst_leaf_gap(prog["change"], ref["change"], keep),
    }


@contextlib.contextmanager
def tf32():
    """Products in TF32 inside the block: the control's precision, the one
    below the configurations' float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def training_readings(out: dict, base: Dict[str, torch.Tensor]) -> dict:
    """A run of a reference's ``train`` as the numbers compared: the losses,
    the first gradient's leaf norms, the change of each leaf from ``base``."""
    return {"losses": out["losses"], "grad1": leaf_norms(out["grad1"]),
            "change": {n: float(torch.linalg.vector_norm((out["params"][n] - p0).double()))
                       for n, p0 in base.items()}}


def program_readings(prog: dict, params_after, base: Dict[str, torch.Tensor]) -> dict:
    """The program's losses and first gradient (``prog``) and the change of
    its params after the steps (host copies) from ``base``."""
    change = {path_name(p): float(torch.linalg.vector_norm((t - base[path_name(p)].cpu()).double()))
              for p, t in params_after}
    return {"losses": prog["losses"], "grad1": prog["grad1"], "change": change}
