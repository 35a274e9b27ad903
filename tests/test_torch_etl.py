"""The port's data stage on the CPU against the JAX package's: the ETL
(`make_dataset_cli.convert` and its CLI) writes the same npy, PNG and
map.csv bytes from the same small raw shards, with --sequences_per_file
1 and 0 and with another number of workers; `build_features` computes
the same statistics; `dotenv` loads the same environment; `download`
lists the same shards and fetches them from an HTTP server on
127.0.0.1."""

import functools
import http.server
import io
import json
import os
import threading

import numpy as np
import pytest
from click.testing import CliRunner

from pivp_tpu.data import build_features as jbf
from pivp_tpu.data import download as jdl
from pivp_tpu.data import make_dataset_cli as jmd
from pivp_tpu.utils import dotenv as jdotenv
from pivp_tpu_torch.data import build_features, download, make_dataset_cli
from pivp_tpu_torch.data import native, tfrecord
from pivp_tpu_torch.utils import dotenv

T, H, W = 3, 48, 64
SHARDS, PER_SHARD = 3, 2
SIZES = dict(sequence_length=T, image_original_width=W,
             image_original_height=H, image_resize_width=16,
             image_resize_height=16)


def _jpeg(seed: int) -> bytes:
    """A 64x48 frame: a square on noise, JPEG-encoded."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 60, (H, W, 3)).astype(np.uint8)
    y, x = rng.randint(0, H - 12), rng.randint(0, W - 12)
    arr[y:y + 12, x:x + 12] = rng.randint(100, 255, 3)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _example(seed: int) -> dict:
    feats = {}
    for i in range(T):
        feats[f"move/{i}/image/encoded"] = [_jpeg(seed * 10 + i)]
        feats[f"move/{i}/commanded_pose/vec_pitch_yaw"] = [
            float(x) for x in np.arange(5) * 0.1 + i + seed]
        feats[f"move/{i}/endeffector/vec_pitch_yaw"] = [
            float(x) for x in -(np.arange(5) * 0.2 + i + seed)]
    return feats


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    for s in range(SHARDS):
        tfrecord.write_records(
            str(d / f"push_train.tfrecord-{s:05d}-of-{SHARDS:05d}"),
            [tfrecord.encode_example(_example(s * PER_SHARD + r))
             for r in range(PER_SHARD)])
    return str(d)


def _tree(d: str) -> dict:
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def converted(raw, tmp_path_factory):
    """{sequences_per_file: (JAX's dir, the port's dir)}."""
    out = {}
    for spf in (1, 0):
        jdir = str(tmp_path_factory.mktemp(f"jax{spf}"))
        tdir = str(tmp_path_factory.mktemp(f"port{spf}"))
        n_j = jmd.convert(raw, jdir, sequences_per_file=spf, num_workers=2,
                          **SIZES)
        before = native.index_records.calls
        n_t = make_dataset_cli.convert(raw, tdir, sequences_per_file=spf,
                                       num_workers=3, **SIZES)
        assert native.index_records.calls - before == SHARDS
        assert n_j == n_t == SHARDS * (PER_SHARD if spf == 0 else 1)
        out[spf] = (jdir, tdir)
    return out


@pytest.mark.parametrize("spf", [1, 0])
def test_convert_writes_jax_bytes(converted, spf):
    jdir, tdir = converted[spf]
    want, got = _tree(jdir), _tree(tdir)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    n = SHARDS * (PER_SHARD if spf == 0 else 1)
    assert np.load(os.path.join(tdir, f"image_batch_{n - 1}.npy")).shape \
        == (T, 16, 16, 3)
    assert np.load(os.path.join(tdir, "action_batch_0.npy")).shape \
        == (T, 1, 5)
    assert np.load(os.path.join(tdir, "image_batch_pred_0.npy")).shape \
        == (T, H, W, 3)
    rows = got["map.csv"].decode().splitlines()
    assert len(rows) == n + 1 and rows[1].startswith('"0",')


def test_cli_matches_convert(raw, converted, tmp_path):
    out = str(tmp_path / "cli")
    args = ["--data_dir", raw, "--out_dir", out, "--num_workers", "1"]
    for key, value in SIZES.items():
        args += [f"--{key}", str(value)]
    result = CliRunner().invoke(make_dataset_cli.main, args)
    assert result.exit_code == 0, result.output
    want = _tree(converted[1][1])
    assert _tree(out) == want       # default --sequences_per_file 1


def test_build_features_matches_jax(converted, tmp_path):
    tdir = converted[0][1]
    want = jbf.compute_statistics(tdir)
    assert build_features.compute_statistics(tdir) == want
    out = str(tmp_path / "features.json")
    result = CliRunner().invoke(build_features.main,
                                ["--data_dir", tdir, "--out_file", out])
    assert result.exit_code == 0, result.output
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(want))


def test_dotenv_matches_jax(tmp_path, monkeypatch):
    (tmp_path / ".env").write_text(
        "# a comment\n\nexport A_KEY=plain\nB_KEY = 'single quoted'\n"
        'C_KEY="double"\nD_KEY=kept\nnot a line\nE_KEY=a=b\n')
    nested = tmp_path / "x" / "y"
    nested.mkdir(parents=True)
    keys = ("A_KEY", "B_KEY", "C_KEY", "D_KEY", "E_KEY")
    results = []
    for module in (jdotenv, dotenv):
        for k in keys:
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv("D_KEY", "from the environment")
        monkeypatch.chdir(nested)
        path = module.find_dotenv()
        assert path == str(tmp_path / ".env")
        assert module.load_dotenv(path) is True
        results.append({k: os.environ.get(k) for k in keys})
    assert results[0] == results[1]
    assert results[1]["D_KEY"] == "from the environment"
    assert dotenv.find_dotenv("no-such-file", start=str(nested)) == ""
    assert dotenv.load_dotenv(str(tmp_path / "missing")) is False


@pytest.fixture
def server(tmp_path):
    """An HTTP server on 127.0.0.1 over a directory of fake shards."""
    root = tmp_path / "bucket"
    files = {}
    for rel in download.shard_listing(["push_testseen"])[:3]:
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        files[rel] = os.urandom(1000 + len(files))
        path.write_bytes(files[rel])

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=str(root)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", files
    httpd.shutdown()
    httpd.server_close()


def test_shard_listing_matches_jax():
    assert download.BUCKET == jdl.BUCKET
    assert download.shard_listing() == jdl.shard_listing()
    for split in download.SPLITS:
        assert download.shard_listing([split]) == jdl.shard_listing([split])
    assert len(download.shard_listing()) == 274


def test_download_from_a_local_server(server, tmp_path, monkeypatch):
    url, files = server
    monkeypatch.setattr(download, "BUCKET", url)
    out = str(tmp_path / "raw")
    rel = next(iter(files))
    path = download.download_file(rel, out)
    assert open(path, "rb").read() == files[rel]
    # An existing non-empty file is kept.
    open(path, "wb").write(b"kept")
    assert open(download.download_file(rel, out), "rb").read() == b"kept"
    # The CLI fetches the listing's first shards, logs a missing one and
    # goes on.
    result = CliRunner().invoke(download.main, [
        "--out_dir", out, "--split", "push_testseen", "--limit", "4"])
    assert result.exit_code == 0, result.output
    for rel, data in files.items():
        got = open(os.path.join(out, rel), "rb").read()
        assert got == (b"kept" if rel == next(iter(files)) else data)
    missing = download.shard_listing(["push_testseen"])[3]
    assert not os.path.exists(os.path.join(out, missing)) or \
        os.path.getsize(os.path.join(out, missing)) == 0
