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

from gcge_tpu_torch.benchmarks import df64_push, pallas_isolate
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
