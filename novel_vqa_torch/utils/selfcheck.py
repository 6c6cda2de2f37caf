"""The card's preflight: build the port's CUDA kernels and check each one
against its plain PyTorch version on the attached card, then one honest
train-step timing (port of ``novel_vqa_tpu.utils.selfcheck``).

The CPU tests run every kernel's plain version only; this CLI runs the
real kernels at the main path's shapes.  Run it once per new card or
CUDA version before trusting a long job:

    python -m novel_vqa_torch.utils.selfcheck            # on the card
    python -m novel_vqa_torch.utils.selfcheck --device cpu

Exits non-zero on any failed check; ends with ``SELFCHECK PASSED``.  Checks:
  1. the step kernel (``csrc/lstm.cu``) against ``lstm_step_plain`` at a
     stack step of the eval route, (N, In, H) = (500, 200, 512) and
     (500, 512, 512), within 1e-5;
  2. the seq kernel against ``lstm_seq_plain`` on ragged right-aligned
     masks, N=500, T=16, In=200 and 512, within 1e-5; and its gradients
     through ``ops/lstm_vjp.FusedSeq`` (the ``NOVEL_VQA_SEQ_TRAIN=1``
     route) against autograd through ``lstm_seq_plain``, the loss
     ``sum(h^2) + sum(sin(hs))`` (the JAX tool's).  Each gradient within
     GRAD_TOL of its largest entry: the JAX tool's TPU bound is 3e-3,
     where the products run in bf16 passes; here both sides are f32 with
     TF32 off and differ only in the kernel's last bits and the order of
     the sums (about 1e-7 of the largest entry between the two backwards
     on the CPU), so 1e-4.  The JAX tool's step-kernel gradient check
     serves ``NOVEL_VQA_PALLAS=all``, which the port leaves out
     (``ops/lstm.py``);
  3. the seq2 kernel (``csrc/lstm2.cu``, bf16 storage) replayed from its
     own saved states (``kernels/lstm2.replay_errors``: finals within
     1e-5, saved states within one bf16 ulp);
  4. each training route through a kernel against the default route at
     dropout 0, arch1's loss and every gradient relative to its largest
     entry: ``NOVEL_VQA_FUSED2=1`` (seq2 forward, bf16 storage) within
     5e-2 (the JAX package's bound for this comparison,
     tests/test_pallas_lstm.py:278); ``NOVEL_VQA_SEQ_TRAIN=1`` (f32,
     only the sum order differs) within 1e-4 (``ROUTE_TOL``);
  5. one arch1 train step per route gives a finite loss;
  6. device time: a bf16 chain of 16 products at 2048 through
     ``core/device_bench.measure_device_time``: exactly 3 calls captured
     (3 times the kernels of one call, at least one per product), and an
     MFU of at most 1.
With ``--device cpu`` the kernels are not checked (there is no card); the
train step and the wall-clock path run (the chain at 256), as the JAX tool
does on a host without a TPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import sys
import time

import numpy as np
import torch

from novel_vqa_torch.core.tree import tree_leaves
from novel_vqa_torch.ops.lstm import ROUTE_ENV

B, E, H, T = 500, 200, 512, 16
CHAIN_N, CHAIN_N_CPU, CHAIN_LEN, CHAIN_CALLS = 2048, 256, 16, 3
KERNEL_TOL = 1e-5
GRAD_TOL = 1e-4
# the routes' loss and gradients against the default route's, at dropout 0
ROUTE_TOL = {"fused2": 5e-2, "seq_train": 1e-4}
ROUTES = ("default", *ROUTE_ENV)


def _close(name, got, ref, failures, tol=KERNEL_TOL):
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
    ok = all(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol) for a, b in zip(got, ref))
    print(f"  {name}: max abs err {err:.2e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)


def grad_rel_errors(fn, plain, args, diff, loss) -> list:
    """The gradients of ``loss(fn(*args))`` and ``loss(plain(*args))`` to
    the inputs ``diff``: for each, the largest difference over the plain
    gradient's largest entry."""
    def grads(f):
        leaves = [a.clone().requires_grad_(i in diff) for i, a in enumerate(args)]
        return torch.autograd.grad(loss(f(*leaves)), [leaves[i] for i in diff])

    return [float((a - b).abs().max() / b.abs().max()) for a, b in zip(grads(fn), grads(plain))]


def route_errors(got, ref) -> tuple:
    """A route's (loss, gradient tree) against the default route's: the
    loss's relative difference, and for each block of the tree the largest
    gradient difference over that gradient's largest entry."""
    loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
    grad_rel = {block: max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                           for a, b in zip(tree_leaves(got[1][block]), tree_leaves(ref[1][block])))
                for block in ref[1]}
    return loss_rel, grad_rel


# the JAX tool's loss (utils/selfcheck.py:113-115) of a layer's (c, h, hs)
def seq_loss(out):
    return (out[1] ** 2).sum() + torch.sin(out[2]).sum()


def _grads_close(name, fn, plain, args, diff, loss, failures):
    rel = max(grad_rel_errors(fn, plain, args, diff, loss))
    ok = rel <= GRAD_TOL
    print(f"  {name}: largest gradient error {rel:.2e} of the largest entry (tol {GRAD_TOL:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)


def _uniform(gen, dev, *shape, scale=1.0):
    return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * scale


def check_kernels(dev, failures):
    from novel_vqa_torch.kernels import build
    from novel_vqa_torch.kernels import lstm as K
    from novel_vqa_torch.kernels import lstm2 as K2
    from novel_vqa_torch.ops.lstm_vjp import FusedSeq

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(build.build, src) for src in ("lstm.cu", "lstm2.cu")]:
            fut.result()
    print(f"0. built the kernels in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(0)

    print("1. step kernel")
    for In in (E, H):
        args = (_uniform(gen, dev, B, In), _uniform(gen, dev, B, H), _uniform(gen, dev, B, H),
                _uniform(gen, dev, In, 4 * H, scale=0.08), _uniform(gen, dev, H, 4 * H, scale=0.08),
                _uniform(gen, dev, 4 * H, scale=0.16))
        got = K.lstm_step(*args)
        _close(f"step N={B} In={In} H={H}", got, K.lstm_step_plain(*args), failures)

    print("2. seq kernel (ragged right-aligned masks), and its gradients through FusedSeq")
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
    mask = (torch.arange(T, device=dev)[:, None] >= (T - lengths)[None, :]).float()
    for In in (E, H):
        args = (_uniform(gen, dev, T, B, In), mask, _uniform(gen, dev, In, 4 * H, scale=0.08),
                _uniform(gen, dev, H, 4 * H, scale=0.08), _uniform(gen, dev, 4 * H, scale=0.16))
        got = K.lstm_seq(*args)
        _close(f"seq N={B} T={T} In={In} H={H}", got, K.lstm_seq_plain(*args), failures)
        _grads_close(f"seq grads (FusedSeq) N={B} T={T} In={In} H={H}", FusedSeq.apply,
                     K.lstm_seq_plain, args, (0, 2, 3, 4), seq_loss, failures)

    print("3. seq2 kernel (replayed from its saved states)")
    bf = torch.bfloat16
    drop = ((torch.rand(T, B, H, generator=gen, device=dev) < 0.5).float() * 2).to(bf)
    ws = [_uniform(gen, dev, *shape, scale=scale).to(bf) for shape, scale in (
        ((E, 4 * H), 0.08), ((H, 4 * H), 0.08), ((4 * H,), 0.16),
        ((H, 4 * H), 0.08), ((H, 4 * H), 0.08), ((4 * H,), 0.16))]
    args = (_uniform(gen, dev, T, B, E).to(bf), mask, drop, *ws)
    got = K2.lstm_seq2(*args)
    replay = K2.replay_errors(args, got)
    free = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, K2.lstm_seq2_plain(*args)))
    ok = all(v <= 1.0 for v in replay.values())
    print(f"  seq2 N={B} In={E} H={H}: replay error / tolerance "
          f"{max(replay.values()):.3g} (at most 1), run free {free:.2e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("seq2 replay")


def check_routes(dev, on_card: bool, failures):
    """Checks 4 and 5: each route through a kernel against the default
    route at dropout 0, and one train step per route."""
    from novel_vqa_torch.core.tree import value_and_grad
    from novel_vqa_torch.models.vqa import arch1
    from novel_vqa_torch.ops.lstm import training_route

    rs = np.random.RandomState(0)
    n = 64
    cfg = arch1.Arch1Config(vocab_size=1000)
    tokens = np.zeros((n, T), np.int64)
    for i, ln in enumerate(rs.randint(1, T + 1, size=n)):
        tokens[i, T - ln:] = rs.randint(1, 1001, size=ln)
    batch = [torch.from_numpy(a).to(dev) for a in (
        tokens, rs.randn(n, cfg.nhimage).astype(np.float32),
        rs.randint(1, cfg.num_output + 1, size=n))]
    routes = ROUTES if on_card else ("default",)

    if on_card:
        print("4. the routes through a kernel vs the default route, dropout 0")
        cfg0 = cfg._replace(dropout=0.0)
        params = arch1.init_params(cfg0, torch.Generator().manual_seed(1), dev)
        res = {}
        for route in routes:
            with training_route(route):
                loss, grads = value_and_grad(arch1.loss_fn)(params, cfg0, *batch, None)
            res[route] = (float(loss), grads)
        for route in routes[1:]:
            loss_rel, grad_rel = route_errors(res[route], res["default"])
            grad_rel = max(grad_rel.values())
            tol = ROUTE_TOL[route]
            ok = loss_rel <= tol and grad_rel <= tol
            print(f"  {route}: loss rel err {loss_rel:.2e}, largest grad rel err {grad_rel:.2e} "
                  f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{route} route")

    print("5. arch1 train step" + (" per route" if on_card else ""))
    for route in routes:
        params = arch1.init_params(cfg, torch.Generator().manual_seed(1), dev)
        tx = arch1.make_optimizer()
        with training_route(route):
            _, _, loss = arch1.train_step(cfg, tx, params, tx.init(params), *batch,
                                          torch.Generator(device=dev).manual_seed(2))
        ok = bool(np.isfinite(float(loss)))
        print(f"  {route}: loss {float(loss):.4f} finite={ok}")
        if not ok:
            failures.append(f"train_step loss ({route})")


def check_device_time(dev, on_card: bool, failures):
    """Check 6: the trace captures the calls, and the implied MFU is at
    most 1."""
    from novel_vqa_torch.core import device_bench as db

    print("6. device-time measurement")
    n = CHAIN_N if on_card else CHAIN_N_CPU
    x = torch.ones(n, n, dtype=torch.bfloat16, device=dev) / n

    def chain():
        y = x
        for _ in range(CHAIN_LEN):
            y = y @ x
        return y

    chain()
    # the kernels one call launches (one product may take more than one),
    # then CHAIN_CALLS calls: the trace must hold exactly that many times
    per_call = db.measure_device_time(chain, 1).summary.total().count
    timing = db.measure_device_time(chain, CHAIN_CALLS)
    if not timing.summary.has_device_plane:
        if on_card:
            print("  FAIL: no device plane in the trace")
            failures.append("device trace")
        else:
            print(f"  no device plane on the CPU (expected): {CHAIN_CALLS} calls in "
                  f"{timing.wall_s * 1e3:.1f} ms of wall clock")
        return
    kernels = timing.summary.total()
    calls = kernels.count / max(per_call, 1)
    s = kernels.total_s
    peak = db.peak_flops(dev)
    mfu = 2.0 * n**3 * CHAIN_LEN * CHAIN_CALLS / s / peak if peak else None
    print(f"  {calls:g} calls captured ({kernels.count} kernels, {per_call} per call), "
          f"{s / CHAIN_CALLS * 1e6:.0f} us per call"
          + (f", chain MFU {mfu:.2f}" if mfu is not None else ", no peak known for this card"))
    if kernels.count != CHAIN_CALLS * per_call or per_call < CHAIN_LEN:
        failures.append("trace capture count")
    if mfu is not None and mfu > 1.0:
        failures.append("MFU > 1 (the clock is wrong)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from novel_vqa_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"device={torch.cuda.get_device_name(dev)} torch={torch.__version__} "
              f"cuda={torch.version.cuda}")
    else:
        print("device=cpu: no card, the kernels are not checked; the train step and the "
              "wall-clock path only")
    failures: list = []
    if on_card:
        check_kernels(dev, failures)
    check_routes(dev, on_card, failures)
    check_device_time(dev, on_card, failures)
    if on_card:
        from novel_vqa_torch.kernels import lstm as K
        from novel_vqa_torch.kernels import lstm2 as K2

        print(f"kernel launches: lstm_seq {K.lstm_seq.launches}, lstm_step "
              f"{K.lstm_step.launches}, lstm_seq2 {K2.lstm_seq2.launches}")
    print("SELFCHECK " + ("PASSED" if not failures else f"FAILED: {failures}"))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
