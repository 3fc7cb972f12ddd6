"""The port's H-SGD training of reduced qwen2-0.5b under the int8 and sign
codecs against the JAX package's, on the CPU (launch.train's default codec
blocks, 8 steps: the reference runs its codecs through Pallas in
interpret mode, which costs ~2.5 s a step at int8's block of 256).

One reference run of launch.train per codec (uniform (2, 2), G=4, I=2, momentum,
batch 4, seq 32, a checkpoint at step 8); from the reference's params and
batches, the port's ``HSGD.run_rounds`` (engine level) and its launch.train:

* CE within RTOL relative at every step, ``lvl`` and ``wire_cum_bytes``
  exact, the ``wire`` line and the header's ``config`` (less ``jit``)
  equal;
* params within ATOL under int8;
* under sign, params within the trajectory's own spread: the largest move
  of the port's step-8 params when its initial params move by one ulp up
  or down.  The sign codec sends one bit an element, and an element near
  zero flips under any rounding difference, moving by its block's scale
  (measured: 0.156 apart from the reference, the same as the port's one-ulp
  spread; the CE agrees to 2.3e-7).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_train import (  # noqa: E402,F401 (a fixture)
    ARCH, ATOL, BASE, RTOL, assert_header_match, assert_records_match,
    ckpt_params, one_torch_thread, ref_params, ref_stream, rel, run_port,
    run_ref)

from repro_torch.comms import Comms  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import (EngineConfig, HSGD, HierarchySpec,  # noqa: E402
                              make_topology)
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.optim import cosine, momentum  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

STEPS = 8
CODECS = ("int8", "sign")


def _argv(codec, ckpt):
    return BASE + ["--steps", str(STEPS), "--comms", codec,
                   "--ckpt-dir", str(ckpt), "--ckpt-every", str(STEPS)]


@pytest.fixture(scope="module")
def p0():
    return ref_params(0)


@pytest.fixture(scope="module", params=CODECS)
def ref_run(request, tmp_path_factory):
    ck = tmp_path_factory.mktemp(f"ref_{request.param}")
    out = run_ref(_argv(request.param, ck))
    out["codec"], out["ckpt"] = request.param, ck
    return out


def _gap(a_dir, b_dir):
    return max(float(np.abs(a - b).max()) for a, b in zip(
        ckpt_params(a_dir, STEPS), ckpt_params(b_dir, STEPS)))


def _ulp(p0, direction):
    return jax.tree.map(lambda a: np.nextafter(
        a, np.float32(direction)).astype(a.dtype), p0)


def test_engine_parity(ref_run, p0):
    pm = build_model(reduced(get_config(ARCH)))
    topo = make_topology("uniform", spec=HierarchySpec((2, 2), (4, 2)))
    eng = HSGD(pm.loss, momentum(cosine(3e-3, STEPS, warmup_steps=0)), topo,
               EngineConfig(comms=Comms(ref_run["codec"])))
    st = eng.init_from_params(params_from_numpy(p0, device="cpu"),
                              device="cpu")
    args = ptrain.build_argparser().parse_args(BASE)
    st, hist = eng.run_rounds(st, ref_stream(args, 512, 4, "cpu"), STEPS)
    ref = ref_run["records"]
    assert [h["t"] for h in hist] == [r["step"] for r in ref]
    cum = 0
    for h, r in zip(hist, ref):
        cum += h["wire_bytes"]
        assert rel(h["ce"], r["loss"]) <= RTOL, (h, r)
        assert cum == r["wire_cum_bytes"]
    # launch.train's line, through JSON (tuples print as lists)
    assert json.loads(json.dumps(eng.wire_stats(st).summary(STEPS))) == \
        ref_run["wire"]
    if ref_run["codec"] == "int8":
        got = [x.numpy().reshape(-1) for x in tree_leaves(st.params)]
        gap = max(float(np.abs(a - b).max()) for a, b in zip(
            got, ckpt_params(ref_run["ckpt"], STEPS)))
        assert gap <= ATOL, gap


def test_trainer_parity(ref_run, p0, tmp_path):
    codec = ref_run["codec"]
    port = run_port(_argv(codec, tmp_path / "p"), p0)
    assert_header_match(port, ref_run)
    assert port["wire"] == ref_run["wire"]
    assert_records_match(port["records"], ref_run["records"])
    gap = _gap(tmp_path / "p", ref_run["ckpt"])
    if codec == "int8":
        assert gap <= ATOL, gap
        return
    spread = 0.0
    for direction in (np.inf, -np.inf):
        d = tmp_path / f"ulp{direction}"
        run_port(_argv(codec, d), _ulp(p0, direction))
        spread = max(spread, _gap(d, tmp_path / "p"))
    assert gap <= max(ATOL, spread), (gap, spread)
