"""The port's two measurement kernels (plain versions, on the CPU) against
the Pallas kernels of ``benchmarks/df64_push.py`` and
``benchmarks/pallas_isolate.py`` in interpret mode.

Both scripts run their whole sweep, non-interpret, when imported, so the
kernels' functions are taken out of the files with ``ast`` and executed here
with small constants (P=16, Q=8, chunks of 128 columns, 3 chunks) and
``interpret=True``; nothing under ``benchmarks/`` is imported or changed.
Inputs come from numpy seeds and go to both sides.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gcge_tpu_torch.benchmarks import (csr_irregular, csr_levels, df64_push,
                                       pallas_isolate)
from gcge_tpu_torch.ops import probes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, Q, NR, G = 16, 8, 128, 3


def _functions(path, names, replace=()):
    """The source of the named top-level functions of a file."""
    with open(os.path.join(REPO, path)) as f:
        src = f.read()
    found = {node.name: ast.get_source_segment(src, node)
             for node in ast.parse(src).body
             if isinstance(node, ast.FunctionDef) and node.name in names}
    assert set(found) == set(names), (path, sorted(found))
    code = "\n\n".join(found[name] for name in names)
    for old, new in replace:
        assert old in code, old
        code = code.replace(old, new)
    return code


@pytest.fixture(scope="module")
def jax_fma_probe():
    ns = {"jnp": jnp, "jax": jax, "pl": pl}
    exec(_functions("benchmarks/df64_push.py", ["fma_probe_kernel"]), ns)

    def run(a, b):
        out = pl.pallas_call(
            ns["fma_probe_kernel"],
            out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
            interpret=True)(jnp.asarray(a), jnp.asarray(b))
        return np.asarray(out)

    return run


@pytest.fixture(scope="module")
def jax_make():
    """``make(mode)`` of pallas_isolate.py at the small constants."""
    ns = {"jnp": jnp, "jax": jax, "pl": pl, "pltpu": pltpu, "P": P, "Q": Q,
          "NR": NR, "SP": 7 * P, "SQ": 7 * Q, "G": G}
    exec(_functions("benchmarks/pallas_isolate.py",
                    ["_two_sum", "peel_stack", "make"],
                    replace=[("interpret=False", "interpret=True")]), ns)
    return ns["make"]


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(0)
    ahi = rng.standard_normal((P, G * NR)).astype(np.float32)
    bhi = rng.standard_normal((Q, G * NR)).astype(np.float32)
    # lo planes as the double-f32 split of an f64 operand gives them: below
    # half an ulp of hi
    a64 = ahi.astype(np.float64) * (1 + 2.0 ** -26 * rng.standard_normal(
        ahi.shape))
    b64 = bhi.astype(np.float64) * (1 + 2.0 ** -26 * rng.standard_normal(
        bhi.shape))
    return (ahi, (a64 - ahi).astype(np.float32),
            bhi, (b64 - bhi).astype(np.float32))


def test_fma_probe_plain_matches_jax_kernel(jax_fma_probe):
    """Dekker block: equal bits with the Pallas kernel.  Block 0: the plain
    version is the exact error of the rounded product (and so equals the
    Dekker block); the Pallas kernel's block 0 is that or, where the compiler
    did not fuse ``a*b - p``, zero."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(probes.PROBE_SHAPE) * 1.7).astype(np.float32)
    b = (rng.standard_normal(probes.PROBE_SHAPE) * 0.3).astype(np.float32)
    jout = jax_fma_probe(a, b)
    tout = probes.fma_probe_plain(torch.as_tensor(a),
                                  torch.as_tensor(b)).numpy()
    assert tout.shape == jout.shape == (16, 128)
    assert np.array_equal(tout[8:].view(np.int32), jout[8:].view(np.int32))
    p = a * b
    exact = (a.astype(np.float64) * b.astype(np.float64)
             - p.astype(np.float64))
    assert np.array_equal(tout[:8].astype(np.float64), exact)
    assert np.array_equal(tout[:8], tout[8:])
    assert np.array_equal(jout[:8], tout[:8]) or not jout[:8].any()
    res = probes.fma_probe(torch.as_tensor(a), torch.as_tensor(b))
    assert res.fused and res.nonzeros == np.count_nonzero(jout[8:]) > 900


def test_fma_probe_rejects_other_operands():
    a = torch.zeros(probes.PROBE_SHAPE)
    with pytest.raises(TypeError):
        probes.fma_probe(a.double(), a.double())
    with pytest.raises(TypeError):
        probes.fma_probe(a[:4], a[:4])


def test_peel_stack_matches_jax(planes):
    """The port's peel against ``gcge_tpu``'s own (the same 7-slice peel in
    the production Gram kernel's module), bit for bit."""
    from gcge_tpu.ops.osgemm_pallas import _peel_stack

    class Stack:            # stands in for the kernel's scratch reference
        def __init__(self):
            self.rows = np.full((7 * P, NR), np.nan, np.float32)

        def __setitem__(self, index, value):
            assert value.dtype == jnp.bfloat16
            self.rows[index] = np.asarray(value.astype(jnp.float32))

    ahi, alo = planes[0][:, :NR], planes[1][:, :NR]
    got = probes.peel_stack(torch.as_tensor(ahi), torch.as_tensor(alo))
    ref = Stack()
    _peel_stack(jnp.asarray(ahi), jnp.asarray(alo), ref, P)
    assert got.dtype == torch.bfloat16 and got.shape == (7 * P, NR)
    assert np.array_equal(got.float().numpy(), ref.rows)


@pytest.mark.parametrize("mode", probes.MODES)
def test_slice_gram_plain_matches_jax_kernel(jax_make, planes, mode):
    """Each mode of the plain version against the Pallas kernel.  Without
    the dot both return zeros.  ``full``: products of 7-bit slices and their
    sums over a 128-column chunk are exact in f32 and the chunk slabs are
    added in the same order, so the bits are equal.  ``dot``: only slice 0 of
    each stack is defined (the Pallas kernel multiplies whatever its scratch
    holds behind it), so the ``[:P, :Q]`` block is compared, to 1e-6 of its
    largest entry: bf16 values of any exponent, f32 sums in another order."""
    jout = np.asarray(jax_make(mode)(*(jnp.asarray(x) for x in planes)))
    tout = probes.slice_gram_plain(*(torch.as_tensor(x) for x in planes),
                                   mode=mode, nr=NR).numpy()
    assert tout.shape == jout.shape == (7 * P, 7 * Q)
    if mode in ("none", "peel"):
        assert not tout.any() and not jout.any()
    elif mode == "full":
        assert np.array_equal(tout, jout)
    else:
        assert not tout[P:].any() and not tout[:, Q:].any()
        scale = np.abs(jout[:P, :Q]).max()
        assert np.abs(tout[:P, :Q] - jout[:P, :Q]).max() <= 1e-6 * scale
    # the wrapper takes the plain version on CPU tensors
    wrapped = probes.slice_gram(*(torch.as_tensor(x) for x in planes),
                                mode=mode, nr=NR).numpy()
    assert np.array_equal(wrapped, tout)


def test_slice_gram_full_recombines_to_f64_gram():
    """``full`` recombined is the Gram of the f64 operands ``(hi + lo)``:
    slice k of an operand is a multiple of 2^-7(k+1) and carries that power
    of two itself, so the 49 slice-pair blocks are added up.  Tolerance 1e-11 of ||a_i|| ||b_j||: seven 7-bit slices hold
    49 bits of each value (2^-50 of the largest entry of a row), and the
    slab's own error is f32 rounding of the chunk adds on terms whose slice
    pair weighs 2^-14 or less beside the leading one.  The operands lie in
    (-1, 1), as the production Gram kernel scales them: slice 0 of a larger
    value needs more than the 8 bits a bf16 holds."""
    rng = np.random.default_rng(1)
    a64 = rng.uniform(-1, 1, (P, G * NR))
    b64 = rng.uniform(-1, 1, (Q, G * NR))
    ahi, bhi = a64.astype(np.float32), b64.astype(np.float32)
    alo, blo = (a64 - ahi).astype(np.float32), (b64 - bhi).astype(np.float32)
    slab = probes.slice_gram_plain(*(torch.as_tensor(x) for x in
                                     (ahi, alo, bhi, blo)),
                                   mode="full", nr=NR).double().numpy()
    gram = np.zeros((P, Q))
    for ka in range(7):
        for kb in range(7):
            gram += slab[ka * P:(ka + 1) * P, kb * Q:(kb + 1) * Q]
    a64 = ahi.astype(np.float64) + alo
    b64 = bhi.astype(np.float64) + blo
    ref = a64 @ b64.T
    norms = np.linalg.norm(a64, axis=1)[:, None] * \
        np.linalg.norm(b64, axis=1)[None, :]
    assert np.max(np.abs(gram - ref) / norms) <= 1e-11


def test_slice_gram_rejects_bad_planes(planes):
    t = [torch.as_tensor(x) for x in planes]
    with pytest.raises(ValueError, match="mode"):
        probes.slice_gram(*t, mode="half")
    with pytest.raises(ValueError, match="multiple"):
        probes.slice_gram(*t, nr=100)
    with pytest.raises(ValueError, match="match"):
        probes.slice_gram(t[0], t[1][:4], t[2], t[3], nr=NR)
    with pytest.raises(TypeError):
        probes.slice_gram(t[0].double(), t[1], t[2], t[3], nr=NR)


@pytest.mark.parametrize("p,n_pad,nr,sms,run,plan", [
    # the script's shape on 132 SMs: 8 row blocks, 16 runs wanted, runs of
    # 10 chunks, the last of 4
    (128, 157696, 1024, 132, None, (10, 16)),
    (16, 157696, 1024, 132, None, (2, 77)),     # one row block
    (128, 5120, 1024, 132, None, (1, 5)),       # more runs wanted than chunks
    (2048, 157696, 1024, 132, None, (154, 1)),  # 128 row blocks: 1 run
    (128, 157696, 1024, 132, 1, (1, 154)),      # the TPU kernel's order
    (32, 1280, 128, 132, 3, (3, 4)),            # a ragged last run
    (32, 1280, 128, 132, 50, (10, 1)),          # one run of every chunk
])
def test_slice_gram_plan(p, n_pad, nr, sms, run, plan):
    got = probes.slice_gram_plan(p, 16, n_pad, nr, sms, run)
    assert (got.run, got.runs) == plan
    assert got.scratch == (plan[1], 7 * p, 7 * 16)
    assert got.runs * got.run >= n_pad // nr > (got.runs - 1) * got.run


def test_slice_gram_plain_in_runs(planes):
    """Summed in runs, the plain version adds each run's chunk slabs, then
    the run sums: at this size every sum is exact, so the bits are those
    of the TPU kernel's order; one run of every chunk is the plain sum of
    the chunk slabs."""
    t = [torch.as_tensor(x) for x in planes]
    ref = probes.slice_gram_plain(*t, nr=NR)
    for run in (1, 2, 3, 7):
        assert torch.equal(probes.slice_gram_plain(*t, nr=NR, run=run), ref)
        assert torch.equal(probes._slice_gram(*t, "full", NR, run), ref)
    sa, sb = probes.stacks(*t)
    slabs = [sa[:, g * NR:(g + 1) * NR].float()
             @ sb[:, g * NR:(g + 1) * NR].float().T for g in range(G)]
    assert torch.equal(probes.slice_gram_plain(*t, nr=NR, run=G),
                       0 + ((slabs[0] + slabs[1]) + slabs[2]))
    for run in (0, -1, 1.5):
        with pytest.raises(ValueError, match="run"):
            probes._slice_gram(*t, "full", NR, run)
        with pytest.raises(ValueError, match="run"):
            probes.slice_gram_plain(*t, nr=NR, run=run)


def test_stacks_and_mma_tile_check_plain():
    """The stacks the dot multiplies: peeled in ``peel``/``full``, slice 0
    ``bf16(hi)`` and zeros behind in ``none``/``dot``; the tile check's
    plain version is the f32 product of its bf16 tiles."""
    rng = np.random.default_rng(2)
    hi = torch.as_tensor(rng.standard_normal((4, 32)).astype(np.float32))
    lo = hi * 1e-8
    for mode in probes.MODES:
        sa, sb = probes.stacks(hi, lo, hi[:2], lo[:2], mode)
        assert sa.shape == (28, 32) and sb.shape == (14, 32)
        if mode in ("peel", "full"):
            assert torch.equal(sa, probes.peel_stack(hi, lo))
        else:
            assert torch.equal(sa[:4], hi.to(torch.bfloat16))
            assert not bool(sa[4:].any()) and not bool(sb[2:].any())
    a = torch.as_tensor(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((112, 64)).astype(np.float32))
    d = probes.bf16_mma_tile_check(a.bfloat16(), b.bfloat16())
    assert torch.equal(d, a.bfloat16().float() @ b.bfloat16().float().T)
    with pytest.raises(TypeError):
        probes.bf16_mma_tile_check(a, b)
    with pytest.raises(TypeError):
        probes.bf16_mma_tile_check(b.bfloat16(), a.bfloat16())


def test_df64_push_main_cpu(capsys):
    assert df64_push.main(["--device", "cpu", "--nx", "6", "--bs", "3", "5",
                           "--trials", "2", "--reps", "2"]) == 0
    out = capsys.readouterr().out
    assert "FMA probe: (a*b - p) == dekker_err exactly: True" in out
    assert out.count("f64 dia nx=6") == 2 and "device: cpu" in out


def test_pallas_isolate_main_cpu(capsys):
    assert pallas_isolate.main(["--device", "cpu", "--p", "16", "--q", "8",
                                "--n", "300", "--nr", "128", "--trials", "2",
                                "--reps", "2"]) == 0
    out = capsys.readouterr().out
    for label in ("loads_only", "peel_only", "dot_only", "full"):
        assert label in out
    assert "n_pad=384" in out


def test_csr_levels_main_cpu(capsys):
    """The CSR-level script on a small FEM pair: a row for every CSR
    operator of the hierarchy at each width, each agreeing with
    torch.sparse.mm to rounding and with equal bits twice."""
    assert csr_levels.main(["--device", "cpu", "--nx", "10", "--widths",
                            "2,3", "--trials", "1", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    rows = [line for line in out.splitlines() if line.startswith("level ")]
    assert "device: cpu" in out and "hierarchy of" in out
    assert rows and len(rows) % 2 == 0
    assert sum(" m=2:" in r for r in rows) == sum(" m=3:" in r for r in rows)
    for r in rows:
        assert r.endswith("equal bits twice True")
        assert float(r.split("rel err ")[1].split(",")[0]) < 1e-13


def test_csr_irregular_main_cpu(capsys):
    """The irregular-operand script on a small Delaunay matrix: a row for
    each operand of the nev=50 and nev=200 solves, each on every tile path
    of ``onehot.PATHS`` with equal bits, agreeing with torch.sparse.mm to
    rounding (f32 to its precision), the plan's choice by width."""
    from gcge_tpu_torch.ops import onehot

    assert csr_irregular.main(["--device", "cpu", "--mesh", "8", "--reps",
                               "1"]) == 0
    out = capsys.readouterr().out
    rows = [line for line in out.splitlines() if line.startswith("nev=")]
    assert "device: cpu" in out and len(rows) == 12
    for r in rows:
        assert r.endswith("paths equal bits True")
        for path in onehot.PATHS:
            assert (f"; {path} " in r) == (path != "panel")
        tol = 1e-6 if "float32" in r else 1e-13
        assert float(r.split("rel err ")[1].split(";")[0]) < tol
        m = int(r.split(" m=")[1].split()[0])
        want = "wide" if m > onehot.CSR_WIDE_M else "split"
        assert f"the plan takes {want};" in r
