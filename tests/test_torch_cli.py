"""The port's front door (matfac_tpu_torch.cli) against the JAX package's
(matfac_tpu.cli): the parser flag for flag and the Params it builds, an
in-process ``main([..., "--cpu"])`` of every single-device algo on the JAX
CLI tests' fixture printing JAX's report lines, the printed numbers from
the same factors, the init overrides, and the refusals (analyze mode; no
CUDA device without --cpu)."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from matfac_tpu import cli as jcli
from matfac_tpu.data import dataset as jdataset
from matfac_tpu.data import io as mfio
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.models import base as jbase
from matfac_tpu.models import increment as jinc
from matfac_tpu.train import loop as jloop
from matfac_tpu_torch import cli as tcli
from matfac_tpu_torch.models import increment as tinc
from matfac_tpu_torch.models.base import state_from_numpy
from matfac_tpu_torch.ops.svd_init import svd_init
from matfac_tpu_torch.train import loop as tloop
from matfac_tpu_torch.train.loop import _pad_rows


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """tests/test_cli.py's fixture: train / test / val splits and the
    ground-truth factors as files."""
    d = tmp_path_factory.mktemp("cli")
    data, uf, vf = synthetic_data(n_users=60, n_items=45, k=3,
                                  density=0.35, seed=5, noise=0.05,
                                  nonneg=True)
    paths = {"dir": str(d)}
    for name, mat in [("train", data.train_mat), ("test", data.test_mat),
                      ("val", data.val_mat)]:
        paths[name] = str(d / f"{name}.csr")
        mfio.write_csr(mat, paths[name])
    for name, f in (("gu", uf), ("gi", vf)):
        paths[name] = str(d / f"{name}.mat")
        mfio.write_factor_mat(f, paths[name])
    return paths


def _argv(files, *extra, prefix="m"):
    return ["--cpu", "--trainmat", files["train"], "--testmat",
            files["test"], "--valmat", files["val"], "--prefix",
            os.path.join(files["dir"], prefix), *extra]


# ----------------------------------------------------------------------
# the parser and the Params it builds
# ----------------------------------------------------------------------

def test_parsers_have_the_same_flags():
    """Every option: names, destination, default, choices, help, type,
    required, nargs. Only prog and the description differ."""
    def flags(ap):
        return [(a.option_strings, a.dest, a.default, a.choices, a.help,
                 a.type, a.required, a.nargs) for a in ap._actions]
    jp, tp = jcli.build_parser(), tcli.build_parser()
    assert flags(tp) == flags(jp)
    assert tp.prog == "matfac_tpu_torch"


EVERY_FLAG = ["--algo", "tmf_bias", "--mf_method", "auto", "--maxiter", "7",
              "--facdim", "12", "--svdfacdim", "5", "--seed", "9", "--ureg",
              "0.2", "--ireg", "0.3", "--learnrate", "0.01", "--rhorms", "2.5",
              "--alpha", "0.5", "--regexponent", "0.25", "--trainmat", "t",
              "--testmat", "s", "--valmat", "v", "--graphmat", "g",
              "--origufac", "ou", "--origifac", "oi", "--initufac", "iu",
              "--initifac", "ii", "--prefix", "out/x", "--batchsize", "999",
              "--bprsampler", "gap", "--bprtries", "3", "--bprengine",
              "dense", "--ccdgroup", "4", "--svdinit", "--quartiles",
              "--cpu", "--resume", "--mode", "analyze"]
REQUIRED = ["--trainmat", "t", "--testmat", "s", "--valmat", "v"]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv", [
    EVERY_FLAG, REQUIRED, REQUIRED + ["--algo", "bprPoissonDropout",
                                      "--mf_method", "sigmoid", "--seed",
                                      "0", "--bprengine", "stream"],
    REQUIRED + ["--facdim", "64", "--learnrate", "0.1", "--ureg", "1e-3",
                "--mode", "train", "--bprsampler", "rankgap"]],
    ids=["every_flag", "required", "bpr_hybrid", "defaults_mixed"])
def test_params_match_jax_field_by_field(argv, monkeypatch):
    """Both parsers read the same flags from one argv, and the port builds
    the Params JAX's main builds (captured where JAX's main hands them to
    Data)."""
    seen = {}

    class Capture:
        def __init__(self, params):
            seen["params"] = params
            raise _Stop

    monkeypatch.setattr(jdataset, "Data", Capture)
    ja, ta = jcli.build_parser().parse_args(argv), \
        tcli.build_parser().parse_args(argv)
    assert vars(ta) == vars(ja)
    with pytest.raises(_Stop):
        jcli.main(argv)
    want = dataclasses.asdict(seen["params"])
    got = dataclasses.asdict(tcli.params_from_args(ta))
    assert got == want


def test_parsers_reject_the_same_argv():
    for argv in (["--trainmat", "t"], REQUIRED + ["--bprsampler", "x"],
                 REQUIRED + ["--mode", "serve"]):
        for ap in (jcli.build_parser(), tcli.build_parser()):
            with pytest.raises(SystemExit):
                ap.parse_args(argv)


# ----------------------------------------------------------------------
# train mode
# ----------------------------------------------------------------------

REPORT = ("RE ", "Test RMSE by", "Val RMSE by", "  Items Part",
          "  Users Part", "increment ranks", "Best val HR@10", "Test HR@10",
          "Test ARHR", "stop:")


def _report(out: str):
    return [s for s in out.splitlines() if s.startswith(REPORT)]


def _shape(lines, counts=True):
    """The lines with their numbers masked (and their integers too unless
    ``counts``)."""
    num = r"-?\d+\.\d+|nan" if counts else r"-?\d+(\.\d+)?|nan"
    return [re.sub(num, "x", s) for s in lines]


def _numbers(lines):
    return [float(x) for s in lines
            for x in re.findall(r"-?\d+\.\d+|nan", s)]


ALGOS = [("mf", "als"), ("mf", "sgd"), ("mf_bias", "sgd"), ("IFWMF", "sgd"),
         ("TMF", "densesgd"), ("TMFDropout", "sgd"), ("tmf_bias", "sgd"),
         ("mf_headwt", "auto"), ("mf_loc", "sgd"), ("mf_freq", "sgd"),
         ("dropoutmf", "sgd"), ("dropoutmf_ordered", "auto"),
         ("dropoutmf_onlyordered", "sgd"), ("increment", "sgd"),
         ("bpr", "train"), ("bprPoissonDropout", "sigmoid"),
         ("mf", "ccd++")]


@pytest.mark.parametrize("algo,method", ALGOS)
def test_main_trains_every_algo_and_prints_jax_report_lines(
        algo, method, files, capsys):
    """In-process main of both packages on the same files: rc 0, the same
    report lines (numbers masked: the runs start from each package's own
    random state, so best epochs and ranks may differ), finite numbers,
    and the factor checkpoint written by the trainers that write one."""
    extra = ["--algo", algo, "--mf_method", method, "--facdim", "4",
             "--maxiter", "4", "--learnrate", "0.02", "--graphmat",
             files["val"]]
    assert jcli.main(_argv(files, *extra, prefix=f"j_{algo}")) == 0
    want = _report(capsys.readouterr().out)
    assert tcli.main(_argv(files, *extra, prefix=f"t_{algo}")) == 0
    out = capsys.readouterr().out
    got = _report(out)
    assert _shape(got, counts=False) == _shape(want, counts=False)
    assert got[-1].startswith("stop: ")
    assert np.all(np.isfinite(_numbers(got)))
    assert ("increment ranks:" in out) == (algo == "increment")
    # every trainer but ModelIncrement's writes the factor checkpoint
    assert any(f.startswith(f"t_{algo}_uFac") for f in
               os.listdir(files["dir"])) == (algo != "increment")


def _shared_state(n_users, n_items, k):
    rng = np.random.default_rng(11)
    return (rng.normal(0, 0.3, (n_users, k)).astype(np.float32),
            rng.normal(0, 0.3, (n_items, k)).astype(np.float32),
            rng.normal(0, 0.1, n_users).astype(np.float32),
            rng.normal(0, 0.1, n_items).astype(np.float32), np.float32(0))


def _fixed(real, to_state):
    """train_model that trains nothing (max_iter 0) from the shared state:
    the report's best state is that state."""
    def train_model(data, params, **kw):
        st = to_state(_shared_state(data.n_users, data.n_items,
                                    params.fac_dim), kw.get("device"))
        kw["init_state_override"] = st
        return real(data, params.replace(max_iter=0), **kw)
    return train_model


@pytest.mark.parametrize("algo", ["mf", "tmf_bias", "dropoutmf", "mf_loc",
                                  "IFWMF", "increment", "bpr",
                                  "bprPoissonDropout"])
def test_printed_numbers_agree_from_the_same_factors(algo, files, capsys,
                                                     monkeypatch):
    """With train_model patched in both packages to return the same
    factors, every printed RMSE, quartile, HR and ARHR number agrees
    within 1e-5, the counts are equal, and both write the same text
    checkpoint files (a bias model's biases beside its factors), byte for
    byte."""
    import jax.numpy as jnp
    j_state = lambda arrs, _: jbase.MFState(*(jnp.asarray(a) for a in arrs))
    t_state = lambda arrs, dev: state_from_numpy(*arrs, device=dev)
    monkeypatch.setattr(jloop, "train_model",
                        _fixed(jloop.train_model, j_state))
    monkeypatch.setattr(tloop, "train_model",
                        _fixed(tloop.train_model, t_state))
    # ModelIncrement starts from its own state: the shared one
    monkeypatch.setattr(jinc, "init_state", lambda p, n, m: j_state(
        _shared_state(n, m, p.fac_dim), None))
    monkeypatch.setattr(tinc, "init_state", lambda p, n, m, device: t_state(
        _shared_state(n, m, p.fac_dim), device))
    extra = ["--algo", algo, "--facdim", "6", "--graphmat", files["val"]]
    assert jcli.main(_argv(files, *extra, prefix=f"jf_{algo}")) == 0
    want = _report(capsys.readouterr().out)
    assert tcli.main(_argv(files, *extra, prefix=f"tf_{algo}")) == 0
    got = _report(capsys.readouterr().out)
    assert _shape(got) == _shape(want)
    assert len(got) >= 4
    np.testing.assert_allclose(_numbers(got), _numbers(want), atol=1e-5)
    written = lambda p: sorted(f[len(p):] for f in os.listdir(files["dir"])
                               if f.startswith(p) and not f.endswith(".npz"))
    names = written(f"tf_{algo}")
    assert names == written(f"jf_{algo}")
    assert any("Bias" in f for f in names) == (algo == "tmf_bias")
    for f in names:
        with open(os.path.join(files["dir"], f"tf_{algo}" + f), "rb") as a, \
                open(os.path.join(files["dir"], f"jf_{algo}" + f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("how", ["initfac", "svdinit"])
def test_init_overrides(how, files, monkeypatch):
    """--initufac/--initifac: both packages start from the files' factors;
    --svdinit: the port starts from its svd_init, padded to the matrix."""
    seen = {}

    def capture(name):
        def train_model(data, params, **kw):
            seen[name] = (kw["init_state_override"], data)
            raise _Stop
        return train_model

    monkeypatch.setattr(jloop, "train_model", capture("jax"))
    monkeypatch.setattr(tloop, "train_model", capture("torch"))
    extra = (["--initufac", files["gu"], "--initifac", files["gi"]]
             if how == "initfac" else ["--svdinit"])
    argv = _argv(files, "--facdim", "3", *extra)
    for mod in ((jcli, tcli) if how == "initfac" else (tcli,)):
        with pytest.raises(_Stop):
            mod.main(argv)
    st, data = seen["torch"]
    if how == "initfac":
        js, _ = seen["jax"]
        for f in ("u_fac", "i_fac"):
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(js, f)))
        np.testing.assert_array_equal(
            st.u_fac.numpy(), mfio.read_factor_mat(files["gu"], 60, 3))
    else:
        u, v, _ = svd_init(data.train_mat, 3, device="cpu")
        np.testing.assert_array_equal(st.u_fac.numpy(),
                                      _pad_rows(u, data.n_users))
        np.testing.assert_array_equal(st.i_fac.numpy(),
                                      _pad_rows(v, data.n_items))
    assert st.u_bias.shape == (data.n_users,)


def test_analyze_mode_names_its_roadmap_item(files):
    with pytest.raises(NotImplementedError, match="item 15"):
        tcli.main(_argv(files, "--mode", "analyze"))


def test_refuses_to_start_without_a_cuda_device(files, monkeypatch):
    """Without --cpu the CLI runs on the card, and raises where none is
    visible rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(files) if a != "--cpu"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)


def test_increment_without_graphmat_raises_like_jax(files):
    for mod in (jcli, tcli):
        with pytest.raises(ValueError, match="probe matrix"):
            mod.main(_argv(files, "--algo", "increment", "--maxiter", "2"))
