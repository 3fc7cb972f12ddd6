"""The port's SSD and RG-LRU kernels and layers on the CPU against the JAX
package's.

Inputs are made with numpy from a seed and handed to both packages.  The
kernel wrappers' CPU route (their plain versions) is held against the
reference's Pallas kernels in interpret mode at the reference's sweep
shapes (``tests/test_kernels.py``) and to its tolerances: for SSD, max
|port - reference| / max |reference| below 1e-4 in float32 and 3e-2 in
bfloat16; for RG-LRU, atol 5e-5 and rtol 1e-4.  The plain versions are
held against ``repro.kernels.ref``, and the layers (conv1d, SSD, RG-LRU,
full-sequence and one-step decode) against the reference's on shared
params at 1e-4.  Then the wrappers' refusals: wrong inputs, strided inputs
read in place, and inputs that require grad.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jrglru_scan  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd_scan  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru_scan as krg  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402

TOL = 1e-4
# the reference's sweeps (tests/test_kernels.py)
SSD_SWEEP = [
    (2, 32, 4, 8, 16, 8),
    (1, 40, 2, 16, 8, 16),   # padded
    (2, 64, 3, 8, 4, 64),    # single chunk
    (1, 16, 1, 4, 4, 4),
]
RGLRU_SWEEP = [
    (2, 32, 8, 8),
    (1, 50, 16, 16),   # padded
    (2, 64, 4, 64),
    (1, 8, 2, 4),
]
DTYPES = {"float32": (np.float32, torch.float32, 1e-4),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 3e-2)}


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _softplus(v):
    return np.logaddexp(v, 0.0).astype(np.float32)


def _ssd_inputs(seed, bt, s, h, p, n, np_dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bt, s, h, p)).astype(np.float32).astype(np_dtype)
    dt = _softplus(rng.normal(size=(bt, s, h)))
    A = -np.exp(rng.normal(size=(h,)) * 0.5).astype(np.float32)
    B = rng.normal(size=(bt, s, n)).astype(np.float32).astype(np_dtype)
    C = rng.normal(size=(bt, s, n)).astype(np.float32).astype(np_dtype)
    return x, dt, A, B, C


def _rglru_inputs(seed, bt, s, w):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(size=(bt, s, w)))) * 0.2 + 0.79)
    b = rng.normal(size=(bt, s, w))
    return a.astype(np.float32), b.astype(np.float32)


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


# --------------------------------------------------------------------------
# the kernels' CPU route against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_SWEEP, ids=str)
def test_ssd_scan_matches_pallas(case, dtype):
    bt, s, h, p, n, chunk = case
    np_dt, t_dt, tol = DTYPES[dtype]
    ins = _ssd_inputs(sum(case), bt, s, h, p, n, np_dt)
    want = jssd_scan(*(jnp.asarray(a) for a in ins), chunk=chunk,
                     interpret=True)
    kssd.reset_launch_counts()
    got = kssd.ssd_scan(*(_to_torch(a) for a in ins), chunk=chunk)
    assert kssd.launch_counts == {"ssd_scan": 0}       # CPU: no launch
    assert got.dtype == t_dt and got.shape == (bt, s, h, p)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-9
    assert _maxdiff(got.float(), want) / scale < tol


def _split3(v):
    """v split by truncation into bf16 hi (v's top 8 significand bits), mid
    (the next 8) and lo (the rest), as the kernel's mma.sync operands.  The
    three sum to v exactly where |v| >= 2^-110, so that lo's last bit,
    2^-23 of v's leading one, is a bit of float32's normal range; below,
    a term that falls among the subnormals keeps only its bits down to
    2^-133 (bf16's subnormal quantum), and the sum is v to within that."""
    terms, rest = [], v
    for _ in range(3):
        term = (rest.view(torch.int32) & -65536).view(torch.float32)
        assert torch.equal(term.to(torch.bfloat16).float(), term)
        rest = rest - term                  # exact in float32
        terms.append(term)
    total = terms[0] + terms[1] + terms[2]
    normal = v.abs() >= 2.0**-110
    assert torch.equal(total[normal], v[normal]) and not rest[normal].any()
    assert bool((rest.abs() < 2.0**-133).all())
    return terms


def _ssd_passes(x, dt, A, B, C, chunk, split):
    """The kernel's four passes (csrc/ssd_scan.cu) in plain torch, on
    inputs upcast to float32 and zero-padded to whole chunks: prep (G = C
    B^T on the causal triangle, cum), chunk_state (s_c = sum_j w_j x_j
    B_j^T), state_pass (the state entering each chunk) and chunk_scan (y =
    M x + exp(cum_i) C . entering).  With ``split`` the products take the
    bf16 route's operands: w B, M and the entering state split exactly
    into three bf16 terms, each term's product with the exact bf16 operand
    summed in float32.  Returns y (Bt, S, H, P) float32 and the scratch in
    the kernel's layouts: states (Bt, nc, H, P, N) (entering), G (Bt, nc,
    Q, Q), cum (Bt, nc, H, Q)."""
    bt, s, h, p = x.shape
    n, q = B.shape[-1], chunk
    nc = -(-s // q)
    pad = nc * q - s
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    xf = xf.view(bt, nc, q, h, p)
    dtf = torch.nn.functional.pad(dt, (0, 0, 0, pad)).view(bt, nc, q, h)
    Bf, Cf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
              .view(bt, nc, q, n) for t in (B, C))
    tri = torch.ones((q, q), dtype=torch.bool).tril()

    def product(eq, exact, b):
        """einsum of an exact operand with b, b split on the bf16 route"""
        if not split:
            return torch.einsum(eq, exact, b)
        return sum(torch.einsum(eq, exact, t) for t in _split3(b))

    # 1. prep
    G = torch.where(tri, torch.einsum("bcin,bcjn->bcij", Cf, Bf), 0.0)
    cum = torch.cumsum(dtf * A, dim=2)                       # (bt, nc, q, h)
    # 2. chunk_state
    w = dtf * torch.exp(cum[:, :, -1:] - cum)
    if split:
        wB = w[..., None] * Bf[:, :, :, None, :]             # (bt,nc,q,h,n)
        sc = product("bcjhp,bcjhn->bchpn", xf, wB)
    else:
        sc = torch.einsum("bcjhp,bcjn->bchpn", w[..., None] * xf, Bf)
    # 3. state_pass
    running = torch.zeros((bt, h, p, n))
    entering = []
    for c in range(nc):
        entering.append(running)
        running = running * torch.exp(cum[:, c, -1])[..., None, None] \
            + sc[:, c]
    E = torch.stack(entering, 1)                             # (bt,nc,h,p,n)
    # 4. chunk_scan
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (bt,nc,i,j,h)
    decay = torch.exp(torch.where(tri[..., None], diff, -torch.inf))
    M = G[..., None] * decay * dtf[:, :, None, :, :]
    yi = product("bcjhp,bcijh->bcihp", xf, M)
    ye = product("bcin,bchpn->bcihp", Cf, E)
    y = yi + torch.exp(cum)[..., None] * ye
    return (y.reshape(bt, nc * q, h, p)[:, :s], E, G,
            cum.transpose(2, 3).contiguous())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_SWEEP, ids=str)
def test_ssd_passes_match_pallas_interpret(case, dtype):
    """The kernel's chunk-parallel passes, emulated (float32 FMAs for
    float32; the bf16 route's exact three-term splits for bfloat16), within
    the reference's tolerance of the Pallas kernel in interpret mode."""
    bt, s, h, p, n, chunk = case
    np_dt, t_dt, tol = DTYPES[dtype]
    ins = _ssd_inputs(sum(case), bt, s, h, p, n, np_dt)
    want = jssd_scan(*(jnp.asarray(a) for a in ins), chunk=chunk,
                     interpret=True)
    y, *_ = _ssd_passes(*(_to_torch(a) for a in ins), chunk,
                        split=dtype == "bfloat16")
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-9
    assert _maxdiff(y.to(t_dt).float(), want) / scale < tol


@pytest.mark.parametrize("case", SSD_SWEEP + [(8, 1024, 24, 64, 128, 64)],
                         ids=str)
def test_ssd_plan_sizes_the_scratch(case):
    """ssd_plan gives the shapes and bytes of the passes' float32 scratch:
    at mamba2-130m's full width (8 x 1024) 100,663,296 bytes of chunk
    states, 2,097,152 of G and 786,432 of cum; on the sweep, the shapes of
    the emulated passes' buffers."""
    bt, s, h, p, n, chunk = case
    plan = kssd.ssd_plan(bt, s, h, p, n, chunk)
    nc = -(-s // chunk)
    assert plan["chunks"] == nc
    assert plan["states"] == (bt, nc, h, p, n)
    assert plan["G"] == (bt, nc, chunk, chunk)
    assert plan["cum"] == (bt, nc, h, chunk)
    for k in ("states", "G", "cum"):
        assert plan[f"{k}_bytes"] == 4 * int(np.prod(plan[k]))
    assert plan["bytes"] == sum(plan[f"{k}_bytes"]
                                for k in ("states", "G", "cum"))
    if case[1] == 1024:
        assert (plan["states_bytes"], plan["G_bytes"], plan["cum_bytes"]) \
            == (100663296, 2097152, 786432)
        return
    ins = [_to_torch(a) for a in _ssd_inputs(sum(case), bt, s, h, p, n)]
    _, E, G, cum = _ssd_passes(*ins, chunk, split=False)
    assert (tuple(E.shape), tuple(G.shape), tuple(cum.shape)) \
        == (plan["states"], plan["G"], plan["cum"])


@pytest.mark.parametrize("case", RGLRU_SWEEP, ids=str)
def test_rglru_scan_matches_pallas(case):
    bt, s, w, block = case
    a, b = _rglru_inputs(sum(case), bt, s, w)
    want = jrglru_scan(jnp.asarray(a), jnp.asarray(b), block=block,
                       interpret=True)
    krg.reset_launch_counts()
    got = krg.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert krg.launch_counts == {"rglru_scan": 0}
    assert got.dtype == torch.float32 and got.shape == (bt, s, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-4)


# --------------------------------------------------------------------------
# the plain versions and the model's scans against the reference's
# --------------------------------------------------------------------------
def test_ssd_ref_matches_reference_oracle():
    ins = _ssd_inputs(7, 2, 37, 3, 8, 16)
    jy, jstate = jref.ssd_ref(*(jnp.asarray(a) for a in ins))
    y, state = ref.ssd_ref(*(torch.from_numpy(a) for a in ins))
    assert state.dtype == torch.float32 and state.shape == (2, 3, 8, 16)
    assert _maxdiff(y, jy) < TOL and _maxdiff(state, jstate) < TOL


def test_rglru_ref_matches_reference_oracle():
    a, b = _rglru_inputs(8, 2, 29, 6)
    h0 = np.random.default_rng(9).normal(size=(2, 6)).astype(np.float32)
    for start in (None, h0):
        jh, jlast = jref.rglru_ref(jnp.asarray(a), jnp.asarray(b),
                                   None if start is None
                                   else jnp.asarray(start))
        h, last = ref.rglru_ref(torch.from_numpy(a), torch.from_numpy(b),
                                None if start is None
                                else torch.from_numpy(start))
        assert _maxdiff(h, jh) < TOL and _maxdiff(last, jlast) < TOL


@pytest.mark.parametrize("case", [(2, 32, 3, 8, 16, 8), (1, 64, 2, 16, 8, 64),
                                  (2, 40, 2, 4, 4, 8)], ids=str)
def test_chunked_ssd_scan_ref_matches_reference(case):
    bt, s, h, p, n, chunk = case
    ins = _ssd_inputs(sum(case), bt, s, h, p, n)
    jy, jstate = JL.ssd_scan_ref(*(jnp.asarray(a) for a in ins), chunk)
    y, state = L.ssd_scan_ref(*(torch.from_numpy(a) for a in ins), chunk)
    assert _maxdiff(y, jy) < TOL and _maxdiff(state, jstate) < TOL
    # and against the step-by-step recurrence
    want, want_state = ref.ssd_ref(*(torch.from_numpy(a) for a in ins))
    assert _maxdiff(y, want) < TOL and _maxdiff(state, want_state) < TOL


def test_padded_ssd_scan_equals_the_recurrence():
    ins = [torch.from_numpy(a) for a in _ssd_inputs(3, 2, 21, 2, 8, 4)]
    y, state = L.ssd_scan_padded(*ins, 8)
    want, want_state = ref.ssd_ref(*ins)
    assert y.shape == want.shape
    assert _maxdiff(y, want) < TOL and _maxdiff(state, want_state) < TOL


@pytest.mark.parametrize("s", [1, 2, 7, 33])
def test_linear_scan_is_the_recurrence(s):
    a, b = _rglru_inputs(s, 2, s, 5)
    aa, bb = L.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    h, _ = ref.rglru_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert _maxdiff(bb, h) < TOL
    assert _maxdiff(aa, np.cumprod(a, axis=1)) < TOL


# --------------------------------------------------------------------------
# the layers against the reference's, on shared params
# --------------------------------------------------------------------------
def _nudged(tree, seed):
    rng = np.random.default_rng(seed)

    def nudge(path, a):
        if path[-1].key in ("scale", "A_log", "D", "dt_bias", "b"):
            noise = rng.normal(size=a.shape).astype(np.float32) * 0.1
            return (np.asarray(a, np.float32) + noise).astype(a.dtype)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(nudge, jax.device_get(tree))


def _layer_world(arch, init, seed=0):
    jcfg = jreduced(jget_config(arch))
    pcfg = reduced(get_config(arch))
    jp = _nudged(init(jax.random.PRNGKey(seed), jcfg), seed)
    return jcfg, pcfg, jp, params_from_numpy(jp, device="cpu")


def _act(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_conv1d_apply_and_step_match_reference():
    jp = _nudged(JL.conv1d_init(jax.random.PRNGKey(1), 12, 4, jnp.float32), 1)
    pp = params_from_numpy(jp, device="cpu")
    x = _act(2, 2, 9, 12)
    assert _maxdiff(L.conv1d_apply(pp, torch.from_numpy(x)),
                    JL.conv1d_apply(jp, jnp.asarray(x))) < TOL
    buf = _act(3, 2, 3, 12)
    jbuf, jout = JL.conv1d_step(jp, jnp.asarray(buf), jnp.asarray(x[:, 0]))
    pbuf, pout = L.conv1d_step(pp, torch.from_numpy(buf),
                               torch.from_numpy(x[:, 0]))
    assert _maxdiff(pout, jout) < TOL and _maxdiff(pbuf, jbuf) < TOL


@pytest.mark.parametrize("s", [16, 21])     # a multiple of the chunk (8), not
def test_ssd_apply_matches_reference(s):
    jcfg, pcfg, jp, pp = _layer_world("mamba2-130m", JL.ssd_init)
    x = _act(s, 2, s, pcfg.d_model)
    want = JL.ssd_apply(jp, jnp.asarray(x), jcfg)
    assert _maxdiff(L.ssd_apply(pp, torch.from_numpy(x), pcfg), want) < TOL


def test_ssd_decode_matches_reference():
    jcfg, pcfg, jp, pp = _layer_world("mamba2-130m", JL.ssd_init, seed=1)
    di = pcfg.ssm_expand * pcfg.d_model
    nh = di // pcfg.ssm_head_dim
    state = {"ssm": _act(4, 2, nh, pcfg.ssm_head_dim, pcfg.ssm_state),
             "conv": _act(5, 2, pcfg.ssm_conv_width - 1,
                          di + 2 * pcfg.ssm_state)}
    x = _act(6, 2, 1, pcfg.d_model)
    jy, jst = JL.ssd_decode(jp, jnp.asarray(x), jcfg,
                            {k: jnp.asarray(v) for k, v in state.items()})
    py, pst = L.ssd_decode(pp, torch.from_numpy(x), pcfg,
                           {k: torch.from_numpy(v) for k, v in state.items()})
    assert _maxdiff(py, jy) < TOL
    for k in ("ssm", "conv"):
        assert _maxdiff(pst[k], jst[k]) < TOL


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_core_matches_reference(with_h0):
    jcfg, pcfg, jp, pp = _layer_world("recurrentgemma-2b", JL.rglru_init)
    xs = _act(7, 2, 19, pcfg.rglru_width)
    h0 = _act(8, 2, pcfg.rglru_width) if with_h0 else None
    jys, jh = JL.rglru_core(jp, jnp.asarray(xs),
                            None if h0 is None else jnp.asarray(h0))
    pys, ph = L.rglru_core(pp, torch.from_numpy(xs),
                           None if h0 is None else torch.from_numpy(h0))
    assert _maxdiff(pys, jys) < TOL and _maxdiff(ph, jh) < TOL


def test_rglru_apply_and_decode_match_reference():
    jcfg, pcfg, jp, pp = _layer_world("recurrentgemma-2b", JL.rglru_init,
                                      seed=2)
    x = _act(9, 2, 13, pcfg.d_model)
    assert _maxdiff(L.rglru_apply(pp, torch.from_numpy(x), pcfg),
                    JL.rglru_apply(jp, jnp.asarray(x), jcfg)) < TOL
    w = pcfg.rglru_width
    state = {"h": _act(10, 2, w), "conv": _act(11, 2, pcfg.conv1d_width - 1,
                                               w)}
    jy, jst = JL.rglru_decode(jp, jnp.asarray(x[:, :1]), jcfg,
                              {k: jnp.asarray(v) for k, v in state.items()})
    py, pst = L.rglru_decode(pp, torch.from_numpy(x[:, :1]), pcfg,
                             {k: torch.from_numpy(v)
                              for k, v in state.items()})
    assert _maxdiff(py, jy) < TOL
    for k in ("h", "conv"):
        assert _maxdiff(pst[k], jst[k]) < TOL


# --------------------------------------------------------------------------
# the wrappers' refusals and layouts
# --------------------------------------------------------------------------
def _torch_ssd(seed=0, bt=2, s=12, h=2, p=4, n=8):
    return [torch.from_numpy(a) for a in _ssd_inputs(seed, bt, s, h, p, n)]


def test_ssd_scan_refuses_what_it_does_not_take():
    x, dt, A, B, C = _torch_ssd()
    with pytest.raises(TypeError, match="share one dtype"):
        kssd.ssd_scan(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kssd.ssd_scan(x.double(), dt, A, B.double(), C.double())
    with pytest.raises(TypeError, match="dt and A must be float32"):
        kssd.ssd_scan(x, dt.double(), A, B, C)
    with pytest.raises(ValueError, match="4-D"):
        kssd.ssd_scan(x[0], dt, A, B, C)
    with pytest.raises(ValueError, match="want dt"):
        kssd.ssd_scan(x, dt[:, :5], A, B, C)
    with pytest.raises(ValueError, match="want dt"):
        kssd.ssd_scan(x, dt, A, B, C[..., :4])
    with pytest.raises(ValueError, match="chunk"):
        kssd.ssd_scan(x, dt, A, B, C, chunk=0)
    with pytest.raises(ValueError, match="on meta"):
        kssd.ssd_scan(x.to("meta"), dt, A, B, C)


def test_rglru_scan_refuses_what_it_does_not_take():
    a, b = (torch.from_numpy(t) for t in _rglru_inputs(0, 2, 6, 3))
    with pytest.raises(TypeError, match="float32"):
        krg.rglru_scan(a.double(), b)
    with pytest.raises(ValueError, match="3-D"):
        krg.rglru_scan(a[0], b[0])
    with pytest.raises(ValueError, match="one shape"):
        krg.rglru_scan(a, b[:, :3])
    with pytest.raises(ValueError, match="on meta"):
        krg.rglru_scan(a.to("meta"), b.to("meta"))


def test_ssd_scan_reads_strided_inputs_in_place():
    """ssd_apply hands the wrapper column slices of one projection: the
    kernel reads them through their row strides, with no copy, and the
    result equals that of contiguous copies."""
    bt, s, h, p, n = 2, 12, 3, 4, 8
    di = h * p
    xbc = torch.from_numpy(_act(12, bt, s, di + 2 * n))
    xs, B, C = torch.split(xbc, [di, n, n], dim=-1)
    x = xs.reshape(bt, s, h, p)
    assert not (x.is_contiguous() or B.is_contiguous() or C.is_contiguous())
    (kx, kB, kC), strides = kssd.kernel_operands(x, B, C)
    assert all(t.data_ptr() == u.data_ptr()
               for t, u in ((kx, x), (kB, B), (kC, C)))
    row = s * (di + 2 * n)
    assert strides == (row, di + 2 * n) * 3
    # a layout whose inner dims are not packed is copied
    xt = torch.from_numpy(_act(13, bt, s, p, h)).transpose(2, 3)
    (cx, _, _), cstrides = kssd.kernel_operands(xt, B, C)
    assert cx.is_contiguous() and cstrides[:2] == (s * h * p, h * p)
    _, dt, A, _, _ = _torch_ssd(bt=bt, s=s, h=h, p=p, n=n)
    got = kssd.ssd_scan(x, dt, A, B, C, chunk=4)
    want = kssd.ssd_scan(x.contiguous(), dt, A, B.contiguous(),
                         C.contiguous(), chunk=4)
    assert torch.equal(got, want)


def test_smem_bytes_at_mamba2_shape():
    """The largest CTA of the chunk-parallel passes (bf16 chunk_scan at
    Mamba-2's shape; float32 chunk_state at N = 256) leaves room for at
    least two CTAs on an SM (228 KB, 1 KB of it reserved per CTA)."""
    assert kssd.smem_bytes(64, 64, 128) == 74240
    assert kssd.smem_bytes(64, 64, 256) == 82176
    for n in (128, 256):
        assert 2 * (kssd.smem_bytes(64, 64, n) + 1024) <= 233472


def test_kernels_refuse_grad():
    """No kernel has a backward: each wrapper raises on inputs that
    require grad while autograd records, on the CPU as on the card, and
    runs under no_grad / inference_mode."""
    x, dt, A, B, C = _torch_ssd()
    a, b = (torch.from_numpy(t) for t in _rglru_inputs(0, 2, 6, 3))
    q = torch.from_numpy(_act(14, 1, 8, 2, 32))
    calls = {
        "ssd_scan": lambda g: kssd.ssd_scan(g(x), dt, A, B, C, chunk=4),
        "rglru_scan": lambda g: krg.rglru_scan(a, g(b)),
        "flash_attention": lambda g: kattn.flash_attention(g(q), q, q),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=f"{name}.*no backward"):
            call(lambda t: t.clone().requires_grad_(True))
        with torch.no_grad():
            call(lambda t: t.clone().requires_grad_(True))
        call(lambda t: t)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "qwen2-0.5b"])
def test_kernel_route_loss_refuses_grad_and_runs_without(arch):
    pm = build_model(reduced(get_config(arch), use_kernels=True))
    params = pm.init(torch.Generator().manual_seed(0), device="cpu")
    for t in jax.tree.leaves(params):
        if t.is_floating_point():
            t.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, pm.cfg.vocab_size, (2, 17)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    with pytest.raises(NotImplementedError, match="no backward"):
        pm.loss(params, batch)
    with torch.no_grad():
        a, _ = pm.loss(params, batch)
    with torch.inference_mode():
        b, _ = pm.loss(params, batch)
    assert torch.isfinite(a) and float(a) == float(b)
    # the plain route differentiates as before
    plain = build_model(reduced(get_config(arch)))
    loss, _ = plain.loss(params, batch)
    loss.backward()
    assert params["embed"].grad is not None
