"""The port's Chainer checkpoint converter against the JAX package's, both
ways and bit for bit, for the CDNA, DNA and STP heads and per-mask STP;
its CLI round trip; and the npz inspector."""

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from pivp_tpu.config import ModelConfig as JConfig
from pivp_tpu.utils import checkpoint as jckpt
from pivp_tpu.utils import npz_keys as jnpz_keys
from pivp_tpu_torch.config import ModelConfig as TConfig
from pivp_tpu_torch.models import predictor as tpred
from pivp_tpu_torch.utils import checkpoint as tckpt
from pivp_tpu_torch.utils import convert_cli, npz_keys, weights

HW = 16
SIZE = dict(image_height=HW, image_width=HW, sequence_length=4)
HEADS = {"CDNA": dict(model_type="CDNA", num_masks=10),
         "DNA": dict(model_type="DNA", num_masks=1),
         "STP": dict(model_type="STP", num_masks=10),
         "STP_per_mask": dict(model_type="STP", num_masks=10,
                              stp_shared_params=False)}


def _template(head):
    return tpred.init_params(torch.Generator().manual_seed(0),
                             TConfig(**SIZE, **HEADS[head]), device="cpu")


def _jax_params(head, seed=5):
    """Random parameters in the JAX package's layouts and structure (the
    per-mask STP projections a list), drawn with numpy."""
    r = np.random.RandomState(seed)
    flat = {k: r.randn(*v.shape).astype(np.float32)
            for k, v in weights.to_jax_params(_template(head)).items()}
    tree = weights.unflatten(flat)
    ip = tree["head"].get("identity_params")
    if ip is not None and "w" not in ip:
        tree["head"]["identity_params"] = [ip[str(i)] for i in range(len(ip))]
    return JConfig(**SIZE, **HEADS[head]), tree


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("head", list(HEADS))
def test_convert_reference_npz_matches_jax(head, tmp_path):
    jcfg, jparams = _jax_params(head)
    path = str(tmp_path / "chainer.npz")
    jckpt.export_reference_npz(path, jcfg, jparams)
    want = weights.from_jax_params(jckpt.flatten_pytree(
        jckpt.convert_reference_npz(path, jcfg, jparams)))
    got = tckpt.convert_reference_npz(path, TConfig(**SIZE, **HEADS[head]),
                                      _template(head))
    _assert_same_arrays(weights.to_jax_params(got),
                        weights.to_jax_params(want))
    if head == "STP_per_mask":
        assert set(got["head"]["identity_params"]) == {str(i)
                                                       for i in range(9)}


@pytest.mark.parametrize("head", list(HEADS))
def test_export_reference_npz_matches_jax(head, tmp_path):
    jcfg, jparams = _jax_params(head)
    params = weights.from_jax_params(jckpt.flatten_pytree(jparams))
    jckpt.export_reference_npz(str(tmp_path / "jax.npz"), jcfg, jparams)
    tckpt.export_reference_npz(str(tmp_path / "port.npz"),
                               TConfig(**SIZE, **HEADS[head]), params)
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        _assert_same_arrays(dict(b), dict(a))


def test_convert_cli_round_trip(tmp_path):
    """Chainer npz -> import -> the port's checkpoint (which the JAX
    package loads, and which holds the converted params) -> export ->
    the same Chainer npz."""
    jcfg, jparams = _jax_params("STP")
    chainer, ours, back = (str(tmp_path / n) for n in
                           ("chainer.npz", "ours.npz", "back.npz"))
    jckpt.export_reference_npz(chainer, jcfg, jparams)
    opts = ["--model_type", "STP", "--num_masks", "10", "--image_height",
            str(HW), "--image_width", str(HW)]
    runner = CliRunner()
    r = runner.invoke(convert_cli.main, ["import", chainer, ours] + opts)
    assert r.exit_code == 0, r.output
    r = runner.invoke(convert_cli.main, ["export", ours, back] + opts)
    assert r.exit_code == 0, r.output
    with np.load(chainer) as a, np.load(back) as b:
        _assert_same_arrays(dict(b), dict(a))
    loaded = jckpt.load_npz_into(ours, jparams)
    _assert_same_arrays(jckpt.flatten_pytree(loaded),
                        jckpt.flatten_pytree(jparams))


def test_convert_refuses_a_checkpoint_of_another_head(tmp_path):
    jcfg, jparams = _jax_params("DNA")
    path = str(tmp_path / "dna.npz")
    jckpt.export_reference_npz(path, jcfg, jparams)
    with pytest.raises(KeyError, match="cdna_kerns"):
        tckpt.convert_reference_npz(path, TConfig(**SIZE), _template("CDNA"))


def test_npz_keys_describes_as_jax(tmp_path, capsys, monkeypatch):
    jcfg, jparams = _jax_params("CDNA")
    chainer, ours = str(tmp_path / "chainer.npz"), str(tmp_path / "ours.npz")
    jckpt.export_reference_npz(chainer, jcfg, jparams)
    tckpt.save_npz(ours, weights.from_jax_params(
        jckpt.flatten_pytree(jparams)))
    for path in (chainer, ours):
        assert npz_keys.describe(path) == jnpz_keys.describe(path)
    monkeypatch.setattr("sys.argv", ["npz_keys", ours])
    npz_keys.main()
    out = capsys.readouterr().out
    assert out.startswith("enc0/b  (32,)  float32")
    assert out.rstrip().endswith("parameters")
