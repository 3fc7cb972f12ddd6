"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``), on the CPU.

* the reference's four checkpoint tests (``tests/test_checkpoint.py``),
  mirrored on the port;
* byte-identical files: for the same tree and step the port's file is the
  reference's byte for byte (a mixed float32 / bfloat16 / int32 / int8 /
  scalar tree with a leaf over 64 KiB, which msgpack writes as bin32, an
  empty leaf, and more than 15 leaves, an array16 payload);
* files restore both ways between the packages, bit for bit;
* the port's own msgpack codec against ``msgpack`` at every width edge of
  the encodings it writes, both ways (the card's machine has no
  ``msgpack``; the port never imports it);
* an HSGD state round trip, and ``launch.serve --ckpt-dir``.
"""
import os

import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.checkpoint import save as jsave  # noqa: E402

from repro_torch.checkpoint import _msgpack  # noqa: E402
from repro_torch.checkpoint import latest_step, restore, save  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def _np_tree(seed=0):
    """numpy leaves of every dtype a training state holds, a bin32 leaf,
    an empty one and 17 small ones."""
    rng = np.random.default_rng(seed)
    return {
        "a": rng.normal(size=(4, 5)).astype(np.float32),
        "b": {"c": np.arange(7, dtype=np.int32),
              "d": rng.normal(size=(3,)).astype(jnp.bfloat16)},
        "big": rng.normal(size=(70000,)).astype(np.float32),
        "bf_big": rng.normal(size=(3, 20000)).astype(jnp.bfloat16),
        "empty": np.zeros((0, 3), np.float32),
        "i8": np.arange(-5, 5, dtype=np.int8),
        "many": tuple(rng.normal(size=(i + 1,)).astype(np.float32)
                      for i in range(17)),
        "scalar": np.asarray(-2, np.int32),
    }


def _leaves(tree):
    """A tree's leaves (tensors, or numpy / JAX arrays) as tensors."""
    return [x if isinstance(x, torch.Tensor)
            else params_from_numpy(np.asarray(x), device="cpu")
            for x in tree_leaves(tree)]


def _equal(a, b):
    """Two trees' leaves equal in dtype, shape and bits."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the reference's tests, mirrored
# ---------------------------------------------------------------------------
def test_roundtrip_mixed_dtypes(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(4, 5, generator=gen),
            "b": {"c": torch.arange(7, dtype=torch.int32),
                  "d": torch.randn(3, generator=gen).to(torch.bfloat16)},
            "scalar": torch.tensor(2, dtype=torch.int32)}
    save(str(tmp_path), 12, tree)
    step, back = restore(str(tmp_path), tree)
    assert step == 12
    _equal(tree, back)


def test_latest_step(tmp_path):
    tree = {"x": torch.zeros(2)}
    assert latest_step(str(tmp_path)) is None
    save(str(tmp_path), 3, tree)
    save(str(tmp_path), 10, tree)
    assert latest_step(str(tmp_path)) == 10
    step, _ = restore(str(tmp_path), tree)
    assert step == 10
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.msgpack",
                                            "ckpt_00000010.msgpack"]


def test_structure_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(AssertionError):
        restore(str(tmp_path), {"x": torch.zeros(2), "y": torch.zeros(1)})
    with pytest.raises(AssertionError):
        restore(str(tmp_path), {"x": torch.zeros(3)})
    with pytest.raises(AssertionError, match="no checkpoints"):
        restore(str(tmp_path / "none"), {"x": torch.zeros(2)})


def test_train_state_roundtrip(tmp_path):
    """A full HSGD state of an LM round-trips (resume support), onto the
    device and dtypes of the template."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import HSGD, UniformTopology, two_level
    from repro_torch.models import build_model
    from repro_torch.optim import momentum
    model = build_model(reduced(get_config("recurrentgemma-2b"),
                                num_layers=5, param_dtype="bfloat16"))
    eng = HSGD(model.loss, momentum(0.1),
               UniformTopology(two_level(4, 2, 4, 2)))
    st = eng.init(torch.Generator().manual_seed(0), model.init, device="cpu")
    tree = {"params": st.params, "opt": st.opt_state}
    save(str(tmp_path), 0, tree)
    _, back = restore(str(tmp_path), tree)
    _equal(tree, back)
    assert torch.bfloat16 in {x.dtype for x in tree_leaves(back["params"])}
    # a template of other dtypes gets the file's values in its dtypes
    f32 = tree_map(lambda x: x.to(torch.float32), tree)
    _, back = restore(str(tmp_path), f32)
    _equal(f32, back)


# ---------------------------------------------------------------------------
# the reference's file format
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 7, 200, 70000, 2**31 + 5])
def test_files_are_the_references_byte_for_byte(tmp_path, step):
    tree = _np_tree()
    jsave(str(tmp_path / "ref"), step, jax.tree.map(jnp.asarray, tree))
    save(str(tmp_path / "port"), step, params_from_numpy(tree, device="cpu"))
    name = f"ckpt_{step:08d}.msgpack"
    ref = (tmp_path / "ref" / name).read_bytes()
    assert (tmp_path / "port" / name).read_bytes() == ref
    assert len(ref) > 70000 * 4


def test_restore_both_ways(tmp_path):
    tree = _np_tree(1)
    jtree = jax.tree.map(jnp.asarray, tree)
    ptree = params_from_numpy(tree, device="cpu")
    jsave(str(tmp_path / "ref"), 5, jtree)
    step, back = restore(str(tmp_path / "ref"), ptree)
    assert step == 5
    _equal(ptree, back)
    save(str(tmp_path / "port"), 6, ptree)
    step, jback = jrestore(str(tmp_path / "port"), jtree)
    assert step == 6
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(jback)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_save_is_atomic_and_leaves_no_temp(tmp_path, monkeypatch):
    """A write that fails midway leaves the directory as it was."""
    from repro_torch.checkpoint import ckpt
    save(str(tmp_path), 1, {"x": torch.ones(3)})

    def broken(t):
        def gen():
            yield b"\0"
            raise OSError("disk full")
        return gen
    monkeypatch.setattr(ckpt, "_chunks", broken)
    with pytest.raises(OSError, match="disk full"):
        save(str(tmp_path), 2, {"x": torch.ones(3)})
    assert os.listdir(tmp_path) == ["ckpt_00000001.msgpack"]


def test_chunked_write(tmp_path, monkeypatch):
    """A leaf larger than a write chunk goes out in pieces, same bytes."""
    from repro_torch.checkpoint import ckpt
    tree = params_from_numpy(_np_tree(2), device="cpu")
    save(str(tmp_path / "one"), 3, tree)
    monkeypatch.setattr(ckpt, "CHUNK_BYTES", 1000)
    save(str(tmp_path / "many"), 3, tree)
    assert (tmp_path / "one" / "ckpt_00000003.msgpack").read_bytes() == \
        (tmp_path / "many" / "ckpt_00000003.msgpack").read_bytes()


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------
EDGES = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
             -2**31 - 1, -2**63],
    "strs": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 65535,
             "a" * 65536, "ünï"],
    "bins": [b"", b"x" * 255, b"x" * 256, b"x" * 65535, b"x" * 65536],
    "arrays": [list(range(15)), list(range(16)), list(range(65535)),
               list(range(65536))],
    "maps": [{f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
             {f"k{i}": i for i in range(65536)}],
}


@pytest.mark.parametrize("kind", sorted(EDGES))
def test_codec_matches_msgpack_at_every_width(kind, tmp_path):
    import io
    for obj in EDGES[kind]:
        want = msgpack.packb(obj, use_bin_type=True)
        buf = io.BytesIO()
        _msgpack.write(buf, obj)
        assert buf.getvalue() == want, (kind, repr(obj)[:40])
        back = _msgpack.read(io.BytesIO(want))
        assert back == obj and type(back) in (type(obj), bytearray)
    for other in (None, True, 1.5):   # no checkpoint holds these
        with pytest.raises(TypeError):
            _msgpack.write(io.BytesIO(), other)
    # a Blob is a bin written in pieces
    buf = io.BytesIO()
    _msgpack.write(buf, _msgpack.Blob(300, lambda: [b"a" * 100, b"b" * 200]))
    assert buf.getvalue() == msgpack.packb(b"a" * 100 + b"b" * 200,
                                           use_bin_type=True)
    with pytest.raises(ValueError):
        _msgpack.write(io.BytesIO(), _msgpack.Blob(3, lambda: [b"ab"]))


# ---------------------------------------------------------------------------
# serving from a checkpoint
# ---------------------------------------------------------------------------
def test_serve_restores_ckpt_dir(tmp_path, capsys):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import main
    from repro_torch.models import build_model
    from repro_torch.serving import DecodeEngine
    model = build_model(reduced(get_config("qwen2-0.5b")))
    p1 = model.init(torch.Generator().manual_seed(1), device="cpu")
    save(str(tmp_path), 4, {"params": p1})
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "2",
            "--prompt-len", "6", "--gen", "5"]
    res = main(argv + ["--ckpt-dir", str(tmp_path)], device="cpu")
    # the launcher's prompt: drawn after the seed-0 init
    gen = torch.Generator().manual_seed(0)
    model.init(gen, device="cpu")
    prompt = torch.randint(0, 512, (2, 6), generator=gen)
    want = DecodeEngine(model, p1, device="cpu").generate(prompt, 5)
    assert torch.equal(torch.as_tensor(res.tokens),
                       torch.as_tensor(want.tokens))
    plain = main(argv, device="cpu")
    assert not torch.equal(torch.as_tensor(plain.tokens),
                           torch.as_tensor(res.tokens))
    capsys.readouterr()
