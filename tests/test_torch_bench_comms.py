"""``repro_torch.experiments.bench_comms`` (the twin of
``benchmarks/bench_comms.py``): its static record against the reference.

For both topologies and all five codecs, the twin's record (the static
``WireStats`` summary over T = 64 steps and each sync event's audited op
count) equals, field for field and exactly, the record the reference
computes live through ``wire_stats(...).summary(T)`` and its own audit
(``benchmarks.bench_comms.bench_one`` without timing), and the static
fields of the committed ``BENCH_comms.json``.  The static asserts
(compression ratios, op counts against the schedule) hold inside the
twin's run; the output refuses the reference's file name.  Timing is the
card's (``chip_smoke.py``), not asserted here.
"""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import bench_comms as JBC  # noqa: E402
from benchmarks.common import make_world as jmake_world  # noqa: E402

from repro_torch.experiments import bench_comms as PBC  # noqa: E402

T = 64
RECORDED = json.loads((ROOT / "BENCH_comms.json").read_text())


@pytest.fixture(scope="module")
def twin():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return PBC.run(quick=True, measure=False, device="cpu")
    finally:
        torch.set_num_threads(n)


def _static(rec):
    """A record as JSON data, its timing dropped."""
    return json.loads(json.dumps(
        {k: v for k, v in rec.items() if k != "steps_per_sec"}))


@pytest.mark.parametrize("topology", sorted(PBC.TOPOLOGIES))
def test_static_record_equals_the_reference_live(topology, twin):
    assert twin["steps"] == T
    ds, model = jmake_world(n_workers=8)
    spec = JBC.TOPOLOGIES[topology]
    row = twin["topologies"][topology]
    assert row["spec"] == {"group_sizes": list(spec.group_sizes),
                           "periods": list(spec.periods)}
    for codec, comms in JBC.CODECS.items():
        want = _static(JBC.bench_one(ds, model, spec, comms, T, False))
        assert _static(row[codec]) == want, (topology, codec)


@pytest.mark.parametrize("topology", sorted(PBC.TOPOLOGIES))
def test_static_record_equals_the_committed_record(topology, twin):
    assert RECORDED["steps"] == T
    want = RECORDED["topologies"][topology]
    got = twin["topologies"][topology]
    assert got["spec"] == want["spec"]
    for codec in PBC.CODECS:
        assert _static(got[codec]) == _static(want[codec]), (topology, codec)


def test_static_asserts_and_refusals(twin, tmp_path):
    """The ratios the twin asserts, and the sync-op counts equal to the
    schedule's (O(dtypes) with comms on, O(leaves) off)."""
    for row in twin["topologies"].values():
        assert row["int8"]["compression_ratio"] > 3.5
        assert row["sign"]["compression_ratio"] > 20.0
        assert row["identity"]["compression_ratio"] == 1.0
        assert set(row["off"]["sync_ops"].values()) == \
            set(row["identity"]["sync_ops"].values()) == {6}
        assert set(row["int8"]["sync_ops"].values()) == {1}
        assert set(row["sign"]["sync_ops"].values()) == {2}
    with pytest.raises(ValueError, match="JAX package's record"):
        PBC.main(out=str(tmp_path / "BENCH_comms.json"), device="cpu")
    if not torch.cuda.is_available():
        # the twin asks for the card unless told otherwise, and refuses
        # to carry on on the CPU by itself
        with pytest.raises(RuntimeError, match="is_available"):
            PBC.run(device="cuda")
