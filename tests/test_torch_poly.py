"""Port parity: the polynomial-basis predictors cn7 ("OCNP"), cn8 and cn9
(nn/predictors/cn_poly.py) and the one-hot cn1 (nn/predictors/cn_ortho.py).

The Chebyshev basis T_p(linspace(-1, 1, N)) is compared at atol 1e-5: the
two linspaces may differ by an ulp, which T_10 magnifies.  The predictors
run four link chunks (three training, one eval) from weights copied out of
the JAX module: forward values, the gradient to the node states and every
parameter gradient at rtol 1e-4 (float32 sums in another order), and cn1's
EMA state after each chunk.  Then each new trainer runs a five-step
trajectory, an epoch and an evaluate against the JAX Trainer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.nn.predictors import build_predictor as jbuild
from ocn_tpu.nn.predictors import cn_poly as jpoly
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from ocn_tpu_torch.nn.predictors import build_predictor as tbuild
from ocn_tpu_torch.nn.predictors import cn_poly as tpoly
from ocn_tpu_torch.weights import load_predictor
from torch_parity import frame_steps, predictor_sequence, trajectory, without_window
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)


@pytest.mark.parametrize("n", [7, 2708, 235868])
def test_chebyshev_basis_matches(n):
    """The closed forms agree exactly on the same points (the port takes
    x**p by repeated squaring, as XLA does); the two linspaces sit at most
    an ulp apart, so each package's own basis differs by at most the
    derivative bound p^2 ulp plus the float32 rounding of the closed form,
    sum|coef| ulp: 1e-5 up to T_6, 4.1e-4 at T_10."""
    xs = jnp.linspace(-1.0, 1.0, n)
    ulp = 2.0 ** -23
    np.testing.assert_allclose(torch.linspace(-1.0, 1.0, n).numpy(),
                               np.asarray(xs), rtol=0, atol=ulp)
    for p in range(len(jpoly.CHEBYSHEV)):
        want = np.asarray(jpoly.chebyshev_basis(n, p))
        same_points = tpoly.CHEBYSHEV[p](torch.as_tensor(np.asarray(xs)))
        np.testing.assert_array_equal(same_points.numpy(), want, err_msg=f"T_{p}")
        coef = np.abs(np.polynomial.chebyshev.cheb2poly([0] * p + [1])).sum()
        atol = max(1e-5, (p * p + coef) * ulp)
        np.testing.assert_allclose(tpoly.chebyshev_basis(n, p).numpy(), want,
                                   rtol=0, atol=atol, err_msg=f"T_{p}")
    with pytest.raises(ValueError):
        tpoly.chebyshev_basis(n, 11)


@pytest.fixture(scope="module")
def steps():
    return frame_steps()


KW = dict(dropout=0.0, ln=True, tailact=True, use_xlin=True, beta=0.8)


# every value of each factor at least once; cn8 ignores the fill
@pytest.mark.parametrize("name,poly_first,poly_second,fill,window", [
    ("cn7", 0, 0, 1.0, False),
    ("cn7", 3, 0, 0.0, True),
    ("cn7", 3, 3, 27.29, False),
    ("cn8", 0, 3, 1.0, True),
    ("cn8", 3, 0, 1.0, False),
])
def test_ocnp_predictor_matches(steps, name, poly_first, poly_second, fill,
                                window):
    kw = dict(KW, polyfirst=poly_first, polysecond=poly_second, sum=fill)
    predictor_sequence(name, kw, steps if window else without_window(steps))


def test_cn9_predictor_matches(steps):
    kw = dict(KW, polyfirst=3, polysecond=3, sum=27.29)
    # y/pos are passed and ignored: the one-hot aggregates gather weights
    predictor_sequence("cn9", kw, steps)


def test_cn1_predictor_matches(steps):
    """Three training chunks step the EMA (n = 1, 2, 3), the eval chunk
    reads it."""
    tp = predictor_sequence("cn1", dict(KW, ln=False, twolayerlin=True),
                            without_window(steps))
    assert int(tp.n) == 3


@pytest.mark.parametrize("name", ["cn1", "cn7", "cn8", "cn9"])
def test_params_from_jax_rejects_unmapped(steps, name):
    s0 = steps[0]
    jp = jbuild(name, 16, s0["n"], **KW)
    v = jax.device_get(jp.init({"params": jax.random.PRNGKey(0)},
                               jnp.asarray(s0["x"]), s0["jg"], *s0["jframes"],
                               jnp.asarray(s0["tar"]), False))
    params, ema = v["params"], v.get("ema", {})
    tp = tbuild(name, 16, 16, n_nodes=s0["n"], **KW)
    load_predictor(tp, params, ema)  # the whole tree lands
    for key in ("Extra_0", "Dense_4", "LayerNorm_2", "xcn3_w1"):
        with pytest.raises(KeyError, match=key):
            load_predictor(tp, {**params, key: params["alpha"]}, ema)
    if not ema:  # cn7, cn8 and cn9 have no EMA state to load
        with pytest.raises(KeyError, match="innerprod"):
            load_predictor(tp, params, {"innerprod": np.zeros(()), "n": 0})


# the trainers: ELL tables, frames capped in the tables (offsets drawn by
# NumPy on both sides); cn7 on bench.py's grouped bfloat16 program with the
# dual-K split, cn1 and cn9 ungrouped in float32 without it.  Learning rates 1e-3,
# as in tests/test_torch_cn6.py: Adam turns float-order noise in near-zero
# gradients into steps of up to lr
TRAJ = dict(model="gcn", mplayers=2, hiddim=16, ln=True, res=True, jk=True,
            use_xlin=True, tailact=True, lnnn=True, gnndp=0.0, xdp=0.0, tdp=0.0,
            gnnedp=0.0, predp=0.0, preedp=0.0, gnnlr=0.001, prelr=0.001,
            ell_tables=True, k_small=4, maskinput=True, batch_size=64,
            linkbatchsize=16, testbs=64, pad_deg=16, pad_deg2=8)


@pytest.fixture(scope="module")
def cora():
    return (jsynthetic("Cora", seed=0, scale=0.1).reorder_bfs(),
            tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs())


@pytest.mark.parametrize("kw", [
    dict(predictor="cn7", sum=27.29, frame_group=2, small_frac=0.5,
         small_frac_neg=0.25, dtype="bfloat16"),
    dict(predictor="cn1", k_small=0),
    dict(predictor="cn9", polyfirst=3, k_small=0),
], ids=["cn7-grouped-bf16", "cn1", "cn9"])
def test_trajectory_matches_jax(cora, kw):
    kw = dict(TRAJ, **kw)
    jt, _, tt, _ = trajectory(kw, *cora)
    assert tt._split == jt._split and tt._use_ell
    if kw["predictor"] == "cn7":
        assert tt._split == (1, 1) and tt.x.dtype == torch.bfloat16
