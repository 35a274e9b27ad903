"""The port's TFRecord reader/writer (data/tfrecord.py) and its native
scanner (csrc/tfrecord_index.cc through data/native.py) on the CPU:
encoded examples and written files byte for byte against the JAX
package's, parsing both ways, the native scan against the plain Python
one, corruption raising IOError in both, and a failed build raising
with the compiler's output."""

import struct

import numpy as np
import pytest

from pivp_tpu.data import tfrecord as jtf
from pivp_tpu_torch.data import native, tfrecord

FEATURES = [
    {"a/bytes": [b"hello", b"world", b""],
     "b/floats": [1.5, -2.25, 3.0, 1e-30],
     "c/ints": [7, 1000000, 0, 2**40]},
    {"move/0/image/encoded": [bytes(range(256)) * 3],
     "move/0/commanded_pose/vec_pitch_yaw": [0.1, 0.2, 0.3, 0.4, 0.5]},
    {"empty": [], "one": [1]},
]


def _records(n=6):
    rng = np.random.RandomState(0)
    return [tfrecord.encode_example({
        "x": [float(v) for v in rng.randn(i + 1)],
        "blob": [rng.bytes(37 * i + 1)]}) for i in range(n)]


@pytest.mark.parametrize("i", range(len(FEATURES)))
def test_encode_and_parse_match_jax(i):
    feats = FEATURES[i]
    rec = tfrecord.encode_example(feats)
    assert rec == jtf.encode_example(feats)
    assert tfrecord.parse_example(rec) == jtf.parse_example(rec)


def test_write_records_matches_jax_byte_for_byte(tmp_path):
    recs = _records()
    tfrecord.write_records(str(tmp_path / "port.tfrecord"), recs)
    jtf.write_records(str(tmp_path / "jax.tfrecord"), recs)
    assert ((tmp_path / "port.tfrecord").read_bytes()
            == (tmp_path / "jax.tfrecord").read_bytes())


@pytest.mark.parametrize("verify", [True, False])
def test_native_scan_matches_the_plain_scan(tmp_path, verify):
    path = str(tmp_path / "r.tfrecord")
    recs = _records()
    tfrecord.write_records(path, recs)
    before = native.index_records.calls
    got = list(tfrecord.read_records(path, verify))
    assert native.index_records.calls == before + 1
    assert got == list(tfrecord.read_records_plain(path, verify)) == recs
    assert [tfrecord.parse_example(r) for r in got] == \
        list(tfrecord.iter_examples(path))


def test_native_crc_matches_python():
    for data in (b"", b"a", b"123456789", bytes(range(256)) * 5):
        assert native.crc32c(data) == tfrecord._crc32c(data)
    # The CRC-32C check value.
    assert native.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("where", ["length_crc", "data", "data_crc"])
def test_corruption_raises_ioerror_in_both(tmp_path, where):
    path = str(tmp_path / "bad.tfrecord")
    tfrecord.write_records(path, _records(3))
    data = bytearray(open(path, "rb").read())
    (length,) = struct.unpack("<Q", data[:8])
    at = {"length_crc": 9, "data": 12 + length // 2,
          "data_crc": 12 + length + 1}[where]
    data[at] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError):
        list(tfrecord.read_records(path))
    with pytest.raises(IOError):
        list(tfrecord.read_records_plain(path))


def test_truncated_and_missing_files_raise(tmp_path):
    path = str(tmp_path / "cut.tfrecord")
    tfrecord.write_records(path, _records(2))
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-3])
    with pytest.raises(IOError):
        list(tfrecord.read_records(path))
    with pytest.raises(IOError):
        list(tfrecord.read_records_plain(path))
    with pytest.raises(IOError):
        list(tfrecord.read_records(str(tmp_path / "missing")))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "tfrecord_index.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        native.get_lib()
    assert not any((tmp_path / "_build").iterdir())
