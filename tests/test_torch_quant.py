"""Port vs JAX package: fixed-point quantization (``core/quant.py``).

The same numpy inputs go through both; codes, fake-quant values and scale
rows must be **equal** — over the whole int8 code domain, including the
``.5`` ties (round half to even) and saturation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core import quant as JQ
from repro_torch.core import quant as TQ

FORMATS = [("Q2_5", JQ.Q2_5, TQ.Q2_5), ("Q3_4", JQ.Q3_4, TQ.Q3_4)]


def _domain(scale: float) -> np.ndarray:
    """Every code, every half-way tie and both saturated ends, plus noise."""
    codes = np.arange(-140, 141, dtype=np.float64)
    pts = np.concatenate([codes, codes + 0.5, codes + 0.25, codes - 0.4999])
    rs = np.random.RandomState(0)
    return np.concatenate([pts / scale, rs.randn(512) * 4,
                           [0.0, -0.0, 1e-9, -1e-9, 1e6, -1e6]]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name,jf,tf", FORMATS)
def test_format_constants_equal(name, jf, tf):
    for attr in ("bits", "scale", "max_code", "min_code", "max_val", "min_val"):
        assert getattr(jf, attr) == getattr(tf, attr)


@pytest.mark.parametrize("name,jf,tf", FORMATS)
@pytest.mark.parametrize("fn", ["to_int", "to_int8", "quantize"])
def test_codes_and_fake_quant_equal(name, jf, tf, fn):
    x = _domain(jf.scale)
    want = np.asarray(getattr(JQ, fn)(jnp.asarray(x), jf))
    got = getattr(TQ, fn)(_t(x), tf).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_code", [127, 7])
def test_round_sat_equal(max_code):
    x = _domain(1.0)
    np.testing.assert_array_equal(
        TQ.round_sat(_t(x), max_code).numpy(),
        np.asarray(JQ.round_sat(jnp.asarray(x), max_code)))


@pytest.mark.parametrize("name,jf,tf", FORMATS)
def test_fake_quant_is_from_int_of_to_int(name, jf, tf):
    x = _t(_domain(tf.scale))
    assert torch.equal(TQ.quantize(x, tf), TQ.from_int(TQ.to_int(x, tf), tf))


def test_fake_quant_backward_is_clipped_ste():
    x = torch.tensor([-5.0, -3.9, 0.3, 3.9, 5.0], requires_grad=True)
    TQ.quantize(x, TQ.Q2_5).sum().backward()
    # Q2.5 represents [-127/32, 127/32] = [-3.96875, 3.96875]
    assert x.grad.tolist() == [0.0, 1.0, 1.0, 1.0, 0.0]


@pytest.mark.parametrize("k,exact", [(9 * 64, True), (1041, False), (2000, False),
                                     (1039, True)])
def test_f32_parity_is_exact(k, exact):
    assert TQ.f32_parity_is_exact(k) == JQ.f32_parity_is_exact(k) == exact


@pytest.mark.parametrize("calibrated", [False, True])
def test_quant_spec_rows_and_codes_equal(calibrated):
    rs = np.random.RandomState(1)
    w = (rs.randn(3, 3, 5, 7) * np.array([0.01, 0.3, 1.0, 3.0, 0.0, 9.0, 0.5])
         ).astype(np.float32)
    x = np.concatenate([_domain(16.0), rs.rand(300).astype(np.float32)])
    if calibrated:
        js, ts = JQ.QuantSpec.calibrate(jnp.asarray(w)), TQ.QuantSpec.calibrate(_t(w))
        np.testing.assert_array_equal(np.asarray(js.w_scales), np.asarray(ts.w_scales))
        assert np.asarray(ts.w_scales).dtype == np.float32
    else:
        js, ts = JQ.QuantSpec(), TQ.QuantSpec()
    assert js.act_scale == ts.act_scale
    np.testing.assert_array_equal(ts.weight_scales(7).numpy(),
                                  np.asarray(js.weight_scales(7)))
    np.testing.assert_array_equal(ts.dequant_row(7).numpy(),
                                  np.asarray(js.dequant_row(7)))
    np.testing.assert_array_equal(ts.weight_codes(_t(w)).numpy(),
                                  np.asarray(js.weight_codes(jnp.asarray(w))))
    np.testing.assert_array_equal(ts.act_codes(_t(x)).numpy(),
                                  np.asarray(js.act_codes(jnp.asarray(x))))


def test_calibrate_activation_scale_equal():
    w = np.random.RandomState(2).randn(1, 1, 4, 6).astype(np.float32)
    js = JQ.QuantSpec.calibrate(jnp.asarray(w), act_absmax=3.7)
    ts = TQ.QuantSpec.calibrate(_t(w), act_absmax=3.7)
    assert js.a_scale == ts.a_scale and js.act_scale == ts.act_scale
    x = _domain(ts.act_scale)
    np.testing.assert_array_equal(ts.act_codes(_t(x)).numpy(),
                                  np.asarray(js.act_codes(jnp.asarray(x))))
