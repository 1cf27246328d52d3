"""`python -m raypt_torch.app.cli` in-process on the CPU (`--device
cpu`), beside the JAX package's `raypt.app.cli.main` with the same
arguments: `render` at 16x16 with `--backend bvh4` and `bvh` (the
accumulation saved by `--checkpoint`, and the PNG), the checkpoint
resume, `--aovs`, `--check`, the onehot flags (fault 3.4), `bench`
(not ported: exits non-zero naming its ROADMAP item) and `inverse` at
8x8 for 3 steps (the parameters it saves)."""
import os

import numpy as np
import pytest
import torch

import raypt.app.cli as jcli
import raypt_torch.app.cli as tcli

torch.set_num_threads(2)

RENDER = ["render", "--size", "16", "--spp", "1", "--bounces", "3"]
# the CLI's accumulation against the JAX CLI's: the same tree (both
# packages build the LBVH bitwise alike), the same walk order and
# keys; measured worst 0.0 on both backends
ACCUM_ATOL = 1e-6
# inverse: 3 Adam steps of the self-target albedo demo (fault 3.8: Adam
# turns last-bit gradient differences into O(lr) steps where a gradient
# is near 0; here no trained gradient is, and the measured worst
# parameter difference is 1.2e-6); the JAX CLI prints its final loss to
# six decimals (measured 1.7e-5 relative, that rounding)
PARAM_ATOL = 1e-4
LOSS_RTOL = 1e-4


def _render(mod, tmp_path, tag, *extra):
    out = str(tmp_path / f"{tag}.png")
    args = RENDER + ["-o", out] + list(extra)
    if mod is tcli:
        args += ["--device", "cpu"]
    return mod.main(args), out


@pytest.mark.parametrize("backend", ["bvh4", "bvh"])
def test_render_vs_jax(backend, tmp_path):
    """render --backend B --checkpoint: the saved accumulation, frame
    index and key match the JAX CLI's, and so does the PNG."""
    paths = {}
    for tag, mod in (("j", jcli), ("t", tcli)):
        ck = str(tmp_path / f"{tag}.npz")
        _, paths[tag] = _render(mod, tmp_path, tag, "--backend", backend,
                                "--checkpoint", ck)
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    np.testing.assert_allclose(t["accum"], j["accum"], atol=ACCUM_ATOL)
    assert int(t["frame_index"]) == int(j["frame_index"]) == 1
    assert np.array_equal(t["key"], j["key"])
    assert (open(paths["t"], "rb").read() == open(paths["j"], "rb").read())


def test_checkpoint_resume(tmp_path):
    """Two runs of --frames 1 on one checkpoint equal one of --frames 2,
    bitwise; the returned accumulation is the one saved."""
    ck = str(tmp_path / "a.npz")
    _render(tcli, tmp_path, "a", "--frames", "1", "--checkpoint", ck)
    acc, _ = _render(tcli, tmp_path, "a", "--frames", "1", "--checkpoint", ck)
    two, _ = _render(tcli, tmp_path, "b", "--frames", "2", "--checkpoint",
                     str(tmp_path / "b.npz"))
    assert torch.equal(acc.view(torch.int32), two.view(torch.int32))
    z = np.load(ck)
    assert int(z["frame_index"]) == 2
    assert np.array_equal(z["accum"], acc.numpy())


def test_aovs_and_check(tmp_path):
    """--aovs writes the three AOV images; --check renders the same
    image as the plain CLI."""
    plain, out = _render(tcli, tmp_path, "p", "--aovs")
    base = os.path.splitext(out)[0]
    for name in ("depth", "normal", "albedo"):
        data = open(f"{base}.{name}.png", "rb").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
    checked, _ = _render(tcli, tmp_path, "c", "--check")
    assert torch.equal(plain, checked)


def test_onehot_flags(tmp_path, monkeypatch):
    """--backend onehot: the compaction group reaches the config only
    with a non-zero --onehot-expand (fault 3.4)."""
    from raypt_torch.render import integrator
    seen = []
    orig = integrator.make_finder

    def spy(scene, cfg, accel=None):
        seen.append(cfg)
        return orig(scene, cfg, accel)

    monkeypatch.setattr(integrator, "make_finder", spy)
    for expand, want in (("0", 0), ("256", 1024)):
        _render(tcli, tmp_path, "o", "--backend", "onehot", "--onehot-leaf",
                "16", "--onehot-expand", expand, "--onehot-compact", "1024")
        assert (seen[-1].onehot_expand, seen[-1].onehot_compact) == (
            int(expand), want)


def test_bench_not_ported(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["bench", "--size", "8"])
    assert e.value.code not in (0, None)
    assert "Port bench" in str(e.value.code)


def _final_loss(err: str) -> float:
    line = [x for x in err.splitlines() if x.startswith("final loss")][-1]
    return float(line.split()[2])


def test_inverse_vs_jax(tmp_path, capsys):
    """inverse (triangle scene, 8x8, 3 steps, bruteforce): the saved
    parameters have the JAX CLI's npz keys and values to PARAM_ATOL, the
    final loss to LOSS_RTOL."""
    args = ["inverse", "--size", "8", "--steps", "3"]
    jcli.main(args + ["-o", str(tmp_path / "j.npz")])
    j_loss = _final_loss(capsys.readouterr().err)
    params, losses = tcli.main(args + ["-o", str(tmp_path / "t.npz"),
                                       "--device", "cpu"])
    assert _final_loss(capsys.readouterr().err) == pytest.approx(
        j_loss, rel=LOSS_RTOL)
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert set(t.files) == set(j.files)
    for k in j.files:
        np.testing.assert_allclose(t[k], j[k], atol=PARAM_ATOL, err_msg=k)
    assert int(t["__step__"]) == 3 and len(losses) == 3
    assert losses[-1] < losses[0]
    assert np.array_equal(t[".albedo_logits"],
                          params.albedo_logits.detach().numpy())
