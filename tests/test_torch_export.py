"""The port's serving artifact (torch.export) against its live serving
function and the JAX package's, its CLI and HTTP server, and the kernel
ops that the artifact holds.

Each head (CDNA through export_cli, from a run directory that names the
head, and loaded by the example HTTP server; DNA, STP shared and
per-mask STP through the API) is exported and loaded once on the CPU, at
full channel widths, 16x16 frames and batch 2. T=3 with one context
frame keeps a fed-back step: export, save and load take time by the
graph's nodes (about 500 a step), not by its widths."""

import io
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from pivp_tpu.config import ModelConfig as JConfig
from pivp_tpu.inference import export as jexport
from pivp_tpu_torch.config import ModelConfig as TConfig
from pivp_tpu_torch.inference import export as texport
from pivp_tpu_torch.inference import export_cli
from pivp_tpu_torch.models import predictor as tpred
from pivp_tpu_torch.utils import checkpoint as tckpt
from pivp_tpu_torch.utils import weights

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import serve_http_torch  # noqa: E402

HW, T, CTX, B = 16, 3, 1, 2
SIZE = dict(image_height=HW, image_width=HW, sequence_length=T,
            context_frames=CTX)
HEADS = {"CDNA": dict(model_type="CDNA", num_masks=10),
         "DNA": dict(model_type="DNA", num_masks=1),
         "STP": dict(model_type="STP", num_masks=10),
         "STP_per_mask": dict(model_type="STP", num_masks=10,
                              stp_shared_params=False)}


@pytest.fixture(scope="module")
def request_data():
    r = np.random.RandomState(2)
    return (r.rand(CTX, B, HW, HW, 3).astype(np.float32),
            (r.randn(T - 1, B, 5) * 0.5).astype(np.float32),
            (r.randn(B, 5) * 0.5).astype(np.float32))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """head -> (cfg, params, the HTTP server (CDNA) or None, loaded
    artifact), each head exported and loaded once, when a test first
    asks for it."""
    made = {}

    def get(head):
        if head in made:
            return made[head]
        cfg = TConfig(**SIZE, **HEADS[head])
        params = tpred.init_params(torch.Generator().manual_seed(3), cfg,
                                   device="cpu")
        root = tmp_path_factory.mktemp(head)
        path = str(root / "serve.pt2")
        if head == "CDNA":
            run = root / "models" / "00000000-000000-CDNA-2"
            run.mkdir(parents=True)
            tckpt.save_npz(str(run / "training-final.npz"), params)
            r = CliRunner().invoke(export_cli.main, [
                run.name, "training-final.npz", path, "--models_dir",
                str(root / "models"), "--batch", str(B), "--device", "cpu",
                "--sequence_length", str(T), "--context_frames", str(CTX),
                "--image_height", str(HW), "--image_width", str(HW)])
            assert r.exit_code == 0, r.output
            httpd = serve_http_torch.make_server(path, port=0)
            made[head] = (cfg, params, httpd, httpd.artifact)
        else:
            texport.export_serving_artifact(params, cfg, B, path)
            made[head] = (cfg, params, None,
                          texport.load_serving_artifact(path))
        return made[head]

    yield get
    if "CDNA" in made:
        made["CDNA"][2].server_close()


@pytest.mark.parametrize("head", list(HEADS))
def test_artifact_frames_equal_make_serve_fn(head, artifacts, request_data):
    cfg, params, _, serve = artifacts(head)
    got = serve(*request_data)
    want = texport.make_serve_fn(params, cfg)(*request_data)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == (T - CTX, B, HW, HW, 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("head", list(HEADS))
def test_artifact_graph_holds_the_kernel_ops(head, artifacts):
    """The CPU implementations run at replay; the export captured each
    launch as a `torch.ops.pivp` node, as it does on the card."""
    cfg, _, _, serve = artifacts(head)
    want = {"lstm_gates_fwd": 7 * (T - 1)}
    if not cfg.is_stp:
        want["local_apply_fwd"] = T - 1
    assert texport.kernel_nodes(serve.exported) == want
    assert serve.in_specs == texport.input_specs(cfg, B)
    assert serve.device == torch.device("cpu")


@pytest.mark.parametrize("head", list(HEADS))
def test_artifact_frames_match_jax(head, artifacts, request_data):
    """The JAX package's serving function on the same weights (through
    utils/weights): the uint8 frames within one level."""
    cfg, params, _, serve = artifacts(head)
    tree = weights.unflatten(weights.to_jax_params(params))
    ip = tree["head"].get("identity_params")
    if ip is not None and "w" not in ip:
        tree["head"]["identity_params"] = [ip[str(i)] for i in range(len(ip))]
    jcfg = JConfig(scheduled_sampling_k=-1.0, **SIZE, **HEADS[head])
    want = np.asarray(jexport.make_serve_fn(tree, jcfg)(*request_data))
    got = serve(*request_data).numpy()
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_loaded_artifact_refuses_another_batch(artifacts, request_data):
    """The program's own shape guard (which the HTTP server checks
    before, to answer 400 and not 500)."""
    *_, serve = artifacts("DNA")
    with pytest.raises(AssertionError):
        serve(*(a[:, :1] if a.ndim > 2 else a[:1] for a in request_data))


def _post(url, body):
    return urllib.request.urlopen(urllib.request.Request(
        url, data=body, method="POST"), timeout=120)


def _npz(**arrays):
    out = io.BytesIO()
    np.savez(out, **arrays)
    return out.getvalue()


def test_http_serving_example(artifacts, request_data):
    """examples/serve_http_torch.py serves the CDNA artifact: a health
    check, a predict round trip equal to the live function, and a 400
    for a malformed body and for a wrong batch."""
    cfg, params, httpd, _ = artifacts("CDNA")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = httpd.server_address
        base = f"http://{host}:{port}"
        assert urllib.request.urlopen(base + "/healthz",
                                      timeout=60).read() == b"ok"
        images, actions, state0 = request_data
        resp = _post(base + "/predict", _npz(
            images=images, actions=actions, state0=state0))
        with np.load(io.BytesIO(resp.read())) as z:
            frames = z["frames"]
        want = texport.make_serve_fn(params, cfg)(*request_data).numpy()
        np.testing.assert_array_equal(frames, want)
        for body in (b"not-an-npz", _npz(images=images[:, :1],
                                         actions=actions[:, :1],
                                         state0=state0[:1])):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + "/predict", body)
            assert e.value.code == 400
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()


def _op_inputs(name):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 6, 7, 3, generator=g)
    w = torch.rand(2, 6, 7, 25, generator=g)
    gy = torch.randn(2, 6, 7, 3, generator=g)
    gates = torch.randn(2, 4, 4, 32, generator=g)
    c, g_c, g_h = (torch.randn(2, 4, 4, 8, generator=g) for _ in range(3))
    return {"local_apply_fwd": (x, w), "local_apply_bwd_w": (x, gy, 5),
            "local_apply_bwd_x": (w, gy),
            "lstm_gates_fwd": (gates, c, 1.0),
            "lstm_gates_bwd": (gates, c, None, g_h, 1.0)}[name]


@pytest.mark.parametrize("name", ["local_apply_fwd", "local_apply_bwd_w",
                                  "local_apply_bwd_x", "lstm_gates_fwd",
                                  "lstm_gates_bwd"])
def test_opcheck(name):
    """Schema, fake (meta) implementation and tracing of each op against
    its CPU implementation."""
    torch.library.opcheck(getattr(torch.ops.pivp, name), _op_inputs(name))
