"""The score path's row-stable dense product (``kernels/row_dense.py``)
on the CPU, where the wrapper runs its plain version.

* The plain version is ``params.dense_apply``'s arithmetic bit for bit,
  so scores on the CPU are what ``anomaly_scores`` gives.
* A window's rows give the same bits alone as inside a batch.
* ``error_bound`` covers a float64 product's distance to the plain one.
* The wrapper checks shapes, dtypes and devices; ``dense_apply`` refuses
  a compute dtype other than float32.
* The score core (``engine.score_windows``) of both detector bodies
  against ``repro``'s score core (a vmap over windows) with ``repro``'s
  params carried over, within rtol 1e-5.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.autoencoder_paper import AutoencoderConfig as JCfg
from repro.models import detector as JD
from repro.serving.anomaly import engine as JE
from repro_torch.configs.autoencoder_paper import AutoencoderConfig as TCfg
from repro_torch.kernels import row_dense as rd
from repro_torch.models import detector as TD
from repro_torch.models import params as P
from repro_torch.serving.anomaly import engine as TE
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(64, 112, 128), (2048, 112, 128), (224, 16, 16), (5, 7, 3)]


def _xwb(M, K, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((M, K), generator=g) * 3,
            torch.randn((K, N), generator=g),
            torch.randn((N,), generator=g))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_is_dense_apply(M, K, N):
    x, w, b = _xwb(M, K, N)
    assert torch.equal(rd.row_dense(x, w, b),
                       P.dense_apply({"w": w, "b": b}, x))
    assert torch.equal(rd.row_dense(x, w), P.dense_apply({"w": w}, x))
    x3 = x.reshape(1, M, K)
    assert torch.equal(rd.dense_apply({"w": w, "b": b}, x3),
                       P.dense_apply({"w": w, "b": b}, x3))
    before = rd.LAUNCHES
    rd.row_dense(x, w, b)
    assert rd.LAUNCHES == before      # the plain version is no launch


@pytest.mark.parametrize("M,K,N", SHAPES[:3])
def test_windows_do_not_depend_on_the_batch(M, K, N):
    """A window's rows (16 of them, or 7 tokens each of 16 for the Seq
    body's 224) give the same bits alone as inside the batch: the score
    path's contract on the CPU too (a single row may take another BLAS
    path; the service never scores fewer rows than a window)."""
    x, w, b = _xwb(M, K, N, seed=1)
    full = rd.row_dense(x, w, b)
    rows = 16 if M != 224 else 112
    for i in sorted({0, (M // 2) // rows * rows, M - rows}):
        assert torch.equal(rd.row_dense(x[i:i + rows], w, b),
                           full[i:i + rows])


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_error_bound_covers_exact_products(M, K, N):
    x, w, b = _xwb(M, K, N, seed=2)
    exact = x.double() @ w.double() + b.double()
    err = (rd.row_dense_plain(x, w, b).double() - exact).abs()
    bound = rd.error_bound(x, w, b)
    assert bound.shape == (M, N) and bool((err <= bound / 2).all())


def test_wrapper_checks():
    x, w, b = _xwb(4, 3, 2)
    with pytest.raises(ValueError, match=r"x \(M, K\) and w \(K, N\)"):
        rd.row_dense(x, w.T)
    with pytest.raises(ValueError, match=r"x \(M, K\)"):
        rd.row_dense(x[None], w)
    with pytest.raises(ValueError, match=r"x \(M, K\)"):
        rd.row_dense(x[:0], w)
    with pytest.raises(ValueError, match=r"b must be \(2,\)"):
        rd.row_dense(x, w, b[:1])
    with pytest.raises(TypeError, match="float32"):
        rd.row_dense(x.double(), w.double())
    with pytest.raises(TypeError, match="float32"):
        rd.dense_apply({"w": w}, x, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rd.row_dense_cuda(x, w, b)


def _repro_scores(jdet, jparams, x):
    rows = jax.tree.map(lambda p: p[None], jparams)
    core = JE._build_score_core(jdet)
    return np.asarray(core(rows, jnp.int32(0), jnp.asarray(x)))


@pytest.mark.parametrize("body", ["ae", "seq"])
def test_score_core_matches_repro(body):
    if body == "ae":
        kw = dict(input_dim=112, hidden=(32, 16), code_dim=8)
        jdet, tdet = JD.AutoencoderDetector(JCfg(**kw)), TCfg(**kw)
    else:
        kw = dict(input_dim=112, window=16, d_model=8)
        jdet, tdet = JD.SeqDetector(**kw), TD.SeqDetector(**kw)
    jp = jdet.init_params(jax.random.PRNGKey(3))
    tp = P.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    x = (np.random.default_rng(4).normal(size=(8, 16, 112)) * 3).astype(
        np.float32)
    want = _repro_scores(jdet, jp, x)
    got = TE.score_windows(tdet, tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (8, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    rows = P.tree_map_with_path(lambda _, p: p[None], tp)
    core = TE.score_core(tdet)(rows, torch.zeros(1, dtype=torch.int64),
                               torch.from_numpy(x))
    assert torch.equal(core, torch.from_numpy(got))


def _service_products(rows):
    """(M, K, N) of each product a bucket of ``rows`` feature rows scores
    with (chip_smoke.py's _score_products): the paper autoencoder's layers
    over the rows, SeqDetector's seven over its (row, token) pairs."""
    ae = TCfg(input_dim=112)
    dims = [ae.input_dim, *ae.hidden, ae.code_dim, *reversed(ae.hidden),
            ae.input_dim]
    seq = TD.SeqDetector()
    t, d, win = rows * seq.seq_len, seq.d_model, seq.window
    w = seq.lru_width or d
    return ([(rows, a, b) for a, b in zip(dims[:-1], dims[1:])]
            + [(t, win, d), (t, d, w), (t, d, w), (t, w, w), (t, w, w),
               (t, w, d), (t, d, win)])


PLAN_SHAPES = sorted({p for rows in (32, 8 * 32, 64 * 32)
                      for p in _service_products(rows)}
                     | {(7, 5, 33), (100_003, 16, 8), (1, 1, 1), (3, 300, 5),
                        (33, 129, 17), (130, 4, 31)})


@pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
def test_row_dense_plan_covers_each_output_once(M, K, N):
    """Every output (m, n) is owned by exactly one thread of the kernel's
    grid (2 rows x 4 columns a thread), and the slabs of each chunk run k
    from 0 to K in order, each k step once (no k padded into a sum); the
    service's K are template constants, so their loops unroll."""
    plan = rd.row_dense_plan(M, K, N)
    rows, cols = rd.ROW_DENSE_TILE
    owned = np.zeros((M, N), np.int64)
    for _, _, _, (m, n) in rd.row_dense_tiles(M, K, N):
        owned[m:m + rows, n:n + cols] += 1
    assert np.all(owned == 1)
    steps = [k for chunk in plan["chunks"] for k0, k1 in chunk
             for k in range(k0, k1)]
    assert steps == list(range(K))
    assert all(0 < k1 - k0 <= rd.ROW_DENSE_SLAB
               for chunk in plan["chunks"] for k0, k1 in chunk)
    assert all(chunk[-1][1] - chunk[0][0] <= rd.ROW_DENSE_CHUNK
               for chunk in plan["chunks"])
    assert plan["k_fixed"] == (K if K in rd.ROW_DENSE_KS else 0)


def test_row_dense_plan_at_the_service_shapes():
    """Every service product's K is a template constant, and the 64-window
    bucket's largest products fill the card: 256 blocks of 128 threads at
    the autoencoder's (2,048, 112, 128), 224 at SeqDetector's (14,336, 16,
    16), about two an SM."""
    for _, K, _ in _service_products(64 * 32):
        assert rd.row_dense_plan(64 * 32, K, 8)["k_fixed"] == K
    ae = rd.row_dense_plan(2048, 112, 128)
    assert (ae["BM"], ae["BN"], ae["grid"]) == (32, 32, (64, 4))
    seq = rd.row_dense_plan(14_336, 16, 16)
    assert (seq["BM"], seq["BN"], seq["grid"]) == (64, 16, (224, 1))
    with pytest.raises(ValueError):
        rd.row_dense_plan(0, 4, 4)
