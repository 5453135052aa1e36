"""The numpy safetensors codec: round trips, and byte-identical files to the
`safetensors` package where it is installed (checkpoints written here load
anywhere, and the checkpoint path needs no package beyond numpy and
ml_dtypes)."""

import ml_dtypes
import numpy as np
import pytest

from eetq_tpu.models.safetensors_np import load_file, safe_open, save_file


def _tensors(rng):
    return {
        "model.embed_tokens.weight": rng.standard_normal((5, 3)).astype(
            np.float16
        ),
        "lm_head.weight": rng.standard_normal((3, 5)).astype(
            ml_dtypes.bfloat16
        ),
        "layers.0.q_proj.weight": rng.integers(-127, 128, (4, 6)).astype(
            np.int8
        ),
        "layers.0.q_proj.weight_scales": rng.random(4).astype(np.float32),
        "step": np.asarray([7], np.int64),
        "mask": np.asarray([True, False]),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.asarray(1.5, np.float64),
    }


def test_roundtrip_every_dtype(rng, tmp_path):
    t = _tensors(rng)
    path = str(tmp_path / "m.safetensors")
    save_file(t, path, metadata={"format": "pt"})
    back = load_file(path)
    assert set(back) == set(t)
    for name, arr in t.items():
        assert back[name].dtype == arr.dtype, name
        assert back[name].shape == arr.shape, name
        np.testing.assert_array_equal(back[name], arr)
    with safe_open(path) as f:
        assert f.metadata() == {"format": "pt"}
        np.testing.assert_array_equal(
            f.get_tensor("layers.0.q_proj.weight"),
            t["layers.0.q_proj.weight"],
        )


def test_header_layout(rng, tmp_path):
    """8-byte length, JSON header padded to 8 bytes, tensors ordered by
    descending dtype rank then name, offsets contiguous."""
    import json
    import struct

    path = tmp_path / "m.safetensors"
    save_file(_tensors(rng), str(path))
    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    assert n % 8 == 0
    header = json.loads(raw[8 : 8 + n])
    names = list(header)
    assert names == [
        "step", "scalar", "empty", "layers.0.q_proj.weight_scales",
        "lm_head.weight", "model.embed_tokens.weight",
        "layers.0.q_proj.weight", "mask",
    ]
    end = 0
    for name in names:
        begin, stop = header[name]["data_offsets"]
        assert begin == end
        end = stop
    assert 8 + n + end == len(raw)


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_bytes_identical_to_the_safetensors_package(rng, tmp_path, metadata):
    st = pytest.importorskip("safetensors.numpy")
    t = _tensors(rng)
    ours = tmp_path / "ours.safetensors"
    theirs = tmp_path / "theirs.safetensors"
    save_file(t, str(ours), metadata=metadata)
    st.save_file(t, str(theirs), metadata=metadata)
    assert ours.read_bytes() == theirs.read_bytes()
    # and the package reads our file
    back = st.load_file(str(ours))
    for name, arr in t.items():
        np.testing.assert_array_equal(back[name], arr)


def test_unsupported_dtype_raises(tmp_path):
    with pytest.raises(TypeError):
        save_file({"c": np.zeros(2, np.complex64)}, str(tmp_path / "x"))
