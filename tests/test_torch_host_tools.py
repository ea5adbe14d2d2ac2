"""The last slice's host-side modules against the JAX package's, on the
CPU: the phase timer and trace, the bucket tables, the depth metrics and
depth-vis LUT, ``visualize_pcd``, ``depth_benchmark``, the ``depth_app``
HTTP round trip and the prompt extender (against a local mock server)."""

import json
import os
import threading
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from worldforge_tpu.utils import buckets as jbuckets
from worldforge_tpu.utils import depth_metrics as jdm
from worldforge_tpu.utils import depth_vis as jvis
from worldforge_tpu.utils import profiling as jprof
from worldforge_tpu.utils import prompt_extend as jpe
from worldforge_tpu_torch.utils import buckets as tbuckets
from worldforge_tpu_torch.utils import depth_metrics as tdm
from worldforge_tpu_torch.utils import depth_vis as tvis
from worldforge_tpu_torch.utils import profiling as tprof
from worldforge_tpu_torch.utils import prompt_extend as tpe
from tests.test_prompt_extend import _echo, _MockChatHandler

torch.set_num_threads(2)


# ------------------------------------------------------------ profiling


def _phases(prof, sync_on):
    with prof.phase("encode", sync_on=sync_on):
        pass
    for _ in range(3):
        with prof.phase("denoise"):
            sum(range(100))
    with prof.phase("encode"):
        pass
    return prof.phase_report(reset=False), prof.phase_report()


def test_phase_report_matches_jax():
    """The same sequence of phases gives the same report keys, calls and
    per-phase fields on both sides; the report resets as JAX's does."""
    jkeep, jrep = _phases(jprof, np.zeros(2, np.float32))
    tkeep, trep = _phases(tprof, {"x": [torch.zeros(2)]})
    for got, want in ((tkeep, jkeep), (trep, jrep)):
        assert list(got) == list(want) == ["encode", "denoise"]
        for name in want:
            assert got[name].keys() == want[name].keys()
            assert got[name]["calls"] == want[name]["calls"]
            assert got[name]["total_s"] >= 0
    assert tprof.phase_report() == jprof.phase_report() == {}


def test_trace_writes_cpu_activity(tmp_path):
    """``trace(cuda=False)`` (asked for by name) records the CPU and writes
    a Chrome trace holding the annotated region."""
    with tprof.trace(str(tmp_path / "tr"), cuda=False) as prof:
        with tprof.annotate("wf_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "tr" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "wf_region" for e in events)
    assert any(e.key == "wf_region" for e in prof.key_averages())


# ----------------------------------------- buckets, metrics, depth vis


def test_bucket_tables_match_jax():
    for key, table in jbuckets._TABLES.items():
        assert tbuckets.get_bucket_config(*key) == table
    for h, w, res in ((480, 832, "480p"), (720, 1280, "720p"),
                      (1024, 256, "480p"), (300, 1900, "720p")):
        for sf in (16, 32, 64, 128, 256):
            assert (tbuckets.closest_bucket(h, w, res, sf)
                    == jbuckets.closest_bucket(h, w, res, sf))
    with pytest.raises(ValueError, match="1080p"):
        tbuckets.get_bucket_config("1080p", 32)


def test_depth_metrics_match_jax(rng):
    gt = rng.uniform(0.5, 3.0, (32, 32))
    pred = 2.5 * gt - 0.7 + 0.05 * rng.standard_normal((32, 32))
    pred[0, 0] = np.nan
    for args in ((pred, gt), (np.full((8, 8), 2.2), np.full((8, 8), 2.0)),
                 (gt.copy(), gt)):
        for align in (True, False):
            assert (tdm.depth_metrics(*args, align=align)
                    == jdm.depth_metrics(*args, align=align))
    a_t = tdm.align_disparity_lstsq(2.5 * gt - 0.7, gt)
    a_j = jdm.align_disparity_lstsq(2.5 * gt - 0.7, gt)
    np.testing.assert_array_equal(a_t[0], a_j[0])
    assert a_t[1:] == a_j[1:]


def test_depth_vis_lut_matches_jax():
    np.testing.assert_array_equal(tvis._inferno_lut(), jvis._inferno_lut())
    d = np.linspace(0, 1, 16, dtype=np.float32).reshape(1, 4, 4)
    for kw in ({}, {"v_min": 0.2, "v_max": 0.7}):
        np.testing.assert_array_equal(tvis.vis_sequence_depth(d, **kw),
                                      jvis.vis_sequence_depth(d, **kw))


# ----------------------------------------------------------- depth CLIs


def _clip(tmp_path):
    """The synthetic npz + mp4 of ``tests/test_pcd.py``."""
    import cv2
    rng = np.random.default_rng(2)
    t, h, w = 4, 16, 24
    np.savez(tmp_path / "clip.npz",
             depth=rng.uniform(0, 1, (t, h, w)).astype(np.float32))
    wr = cv2.VideoWriter(str(tmp_path / "clip_input.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
    for _ in range(t):
        wr.write(rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    wr.release()


def test_visualize_pcd_ply_frames_match_jax(tmp_path):
    from worldforge_tpu.cli import visualize_pcd as jcli
    from worldforge_tpu_torch.cli import visualize_pcd as tcli
    _clip(tmp_path)
    args = ["--data-path", str(tmp_path), "--vid-name", "clip",
            "--downsample-factor", "2", "--max-frames", "3"]
    jcli.main(args + ["--out-dir", str(tmp_path / "j")])
    tcli.main(args + ["--out-dir", str(tmp_path / "t")])
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "t0000.ply", "t0001.ply", "t0002.ply"]
    for n in names:
        assert ((tmp_path / "t" / n).read_bytes()
                == (tmp_path / "j" / n).read_bytes())


def _sequences(tmp_path, n=2, t=3, h=40, w=56):
    """Sequence dirs (``frames/`` + ``depth.npy``) and their CSV."""
    from PIL import Image
    rng = np.random.default_rng(5)
    seqs = []
    for i in range(n):
        seq = tmp_path / f"seq{i}"
        (seq / "frames").mkdir(parents=True)
        for j in range(t):
            Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                            ).save(seq / "frames" / f"f{j:02d}.png")
        np.save(seq / "depth.npy",
                rng.uniform(0.5, 4.0, (t, h, w)).astype(np.float32))
        seqs.append(str(seq))
    (tmp_path / "seqs.csv").write_text("".join(s + "\n" for s in seqs))
    return seqs


def test_depth_benchmark_pred_dir_matches_jax(tmp_path):
    """``--pred-dir``: predictions at another size are resized to the
    ground truth's; the JSON equals JAX's."""
    from worldforge_tpu.cli import depth_benchmark as jcli
    from worldforge_tpu_torch.cli import depth_benchmark as tcli
    seqs = _sequences(tmp_path)
    rng = np.random.default_rng(6)
    (tmp_path / "pred").mkdir()
    for s in seqs:
        np.save(tmp_path / "pred" / (os.path.basename(s) + ".npy"),
                rng.uniform(0.1, 1.0, (3, 32, 48)).astype(np.float32))
    out = {}
    for name, cli in (("j", jcli), ("t", tcli)):
        cli.main(["--csv", str(tmp_path / "seqs.csv"), "--pred-dir",
                  str(tmp_path / "pred"), "--output",
                  str(tmp_path / f"{name}.json")])
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
    assert out["t"] == out["j"]
    assert set(out["t"]["per_sequence"]) == set(seqs)


def test_depth_benchmark_checkpoint_route(tmp_path, monkeypatch):
    """The checkpoint route on the CPU: a tiny synthetic DepthCrafter
    checkpoint (``tests/test_torch_convert.py``'s writers, the loader's
    configs patched to tiny) through ``estimate_depth(device="cpu")``; each
    sequence's metrics equal ``depth_metrics(estimate_depth(...))``."""
    from tests.test_torch_convert import _manifest_sd, _save
    from worldforge_tpu_torch.cli import depth_benchmark as tcli
    from worldforge_tpu_torch.io.frames import load_frames
    from worldforge_tpu_torch.models.depthcrafter import inference as tinf
    from worldforge_tpu_torch.models.depthcrafter import unet as tunet
    from worldforge_tpu_torch.models.depthcrafter import vae as tv
    ckpt = tmp_path / "ckpt"
    for which in ("unet", "vae"):
        (ckpt / which).mkdir(parents=True)
        _save(_manifest_sd(f"svd_{which}_manifest.json", 22),
              str(ckpt / which / "model.safetensors"), "float32")
    monkeypatch.setattr(tunet.SVDUNetConfig, "svd",
                        classmethod(lambda cls: cls.tiny()))
    monkeypatch.setattr(tv.SVDVAEConfig, "svd",
                        classmethod(lambda cls: cls.tiny()))
    seqs = _sequences(tmp_path, h=64, w=64)
    tcli.main(["--csv", str(tmp_path / "seqs.csv"), "--checkpoint_dir",
               str(ckpt), "--num-inference-steps", "1", "--max_res", "64",
               "--device", "cpu", "--output", str(tmp_path / "e.json")])
    got = json.loads((tmp_path / "e.json").read_text())
    for s in seqs:
        depth = tinf.estimate_depth(
            load_frames(os.path.join(s, "frames")), num_inference_steps=1,
            max_res=64, checkpoint=str(ckpt), device="cpu")
        want = tdm.depth_metrics(depth, np.load(os.path.join(s,
                                                             "depth.npy")))
        assert got["per_sequence"][s] == pytest.approx(want, abs=1e-6)


def test_depth_app_roundtrip(tmp_path):
    """JAX's round trip (``tests/test_depth_app.py``) on the port with
    ``--device cpu``: the form, one job through ``POST /run`` (input and
    depth videos and the depth npz written and served under ``/files/``),
    and a bad path back to the form with its error."""
    from http.server import ThreadingHTTPServer

    from PIL import Image
    from worldforge_tpu_torch.cli.depth_app import (_build_pipeline,
                                                    build_parser,
                                                    make_handler)
    rng = np.random.default_rng(0)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(5):
        Image.fromarray(rng.uniform(0, 255, (72, 96, 3)).astype(np.uint8)
                        ).save(frames / f"f_{i:02d}.png")
    args = build_parser().parse_args(
        ["--random-init", "--tiny", "--device", "cpu", "--port", "0",
         "--output-dir", str(tmp_path / "out"), "--window-size", "8",
         "--overlap", "2"])
    pipe = _build_pipeline(args)
    assert pipe.device == torch.device("cpu")
    assert pipe.unet_params["conv_in"]["w"].dtype == torch.bfloat16
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(pipe, args))
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.01},
                     daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            page = r.read().decode()
        assert "num denoising steps" in page and "cfg scale" in page
        body = urllib.parse.urlencode({
            "video": str(frames), "steps": "2", "cfg": "1.0",
            "max_res": "64", "length": "5", "fps": "4"}).encode()
        with urllib.request.urlopen(base + "/run", data=body,
                                    timeout=600) as r:
            assert "Generated depth" in r.read().decode()
        outs = os.listdir(tmp_path / "out")
        assert any(n.endswith("_vis.mp4") for n in outs)
        assert any(n.endswith("_input.mp4") for n in outs)
        npz = [n for n in outs if n.endswith("_depth.npz")]
        depth = np.load(tmp_path / "out" / npz[0])["depth"]
        assert depth.shape == (5, 64, 64) and np.isfinite(depth).all()
        assert 0.0 <= depth.min() and depth.max() <= 1.0
        with urllib.request.urlopen(base + "/files/" + npz[0],
                                    timeout=30) as r:
            assert r.read() == (tmp_path / "out" / npz[0]).read_bytes()
        bad = urllib.parse.urlencode({"video": "/no/such/path",
                                      "steps": "2"}).encode()
        with urllib.request.urlopen(base + "/run", data=bad,
                                    timeout=60) as r:
            assert "color:red" in r.read().decode()
    finally:
        srv.shutdown()


# ------------------------------------------------------ prompt extender


def test_prompt_tables_and_dispatch_match_jax():
    assert tpe.SYSTEM_PROMPT_TYPES == jpe.SYSTEM_PROMPT_TYPES
    for is_vl in (False, True):
        for lang in ("en", "zh"):
            for multi in (False, True):
                t = tpe.LocalPromptExpander(_echo, is_vl=is_vl)
                j = jpe.LocalPromptExpander(_echo, is_vl=is_vl)
                assert (t.decide_system_prompt(lang, multi)
                        == j.decide_system_prompt(lang, multi))
                assert t.is_vl == j.is_vl


def _boom(system, prompt, seed):
    raise RuntimeError("backend down")


def _local_case(mod, case):
    if case == "success_and_seed":
        out = mod.LocalPromptExpander(_echo)("a cat", tar_lang="en", seed=7)
        return (out.status, out.prompt, out.seed, out.system_prompt)
    if case == "failure_falls_back":
        e = mod.LocalPromptExpander(_boom)
        out = e("a cat", tar_lang="en", seed=1)
        return (out.status, out.prompt, out.message,
                mod.enhance_prompt_t2v(e, "a cat", seed=1))
    e = mod.LocalPromptExpander(_echo, is_vl=True)
    e2 = mod.LocalPromptExpander(
        _echo, is_vl=True, generate_vl_fn=lambda s, p, img, seed: p + "!")
    return (e("a cat", image=object(), tar_lang="en", seed=2).status,
            mod.enhance_prompt_i2v(e, "a cat", image=object(), seed=2),
            mod.enhance_prompt_i2v(e2, "a cat", image=object(), seed=2))


@pytest.mark.parametrize("case", ["success_and_seed", "failure_falls_back",
                                  "vl_requires_backend"])
def test_local_expander_matches_jax(case):
    assert _local_case(tpe, case) == _local_case(jpe, case)


def _serve(mock):
    """``tests/test_prompt_extend.py``'s mock server, polled every 10 ms so
    that its shutdown does not wait half a second."""
    import http.server

    srv = http.server.HTTPServer(("127.0.0.1", 0), mock.make_handler())
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.01},
                     daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/v1"


def _hosted(mod, case):
    """One hosted-API case on a fresh mock server: the outputs and the
    requests the server saw."""
    mock = _MockChatHandler()
    mock.fail_next = {"retry_then_success": 2, "exhausted": 99}.get(case, 0)
    srv, url = _serve(mock)
    try:
        kw = {"model_name": "qwen-plus"} if case == "text" else {}
        if case == "exhausted":
            kw["retry_times"] = 2
        if case == "vl_image":
            kw.update(is_vl=True, max_image_size=512 * 512)
        e = mod.OpenAICompatPromptExpander(base_url=url, api_key="test-key",
                                           retry_sleep=0.0, **kw)
        if case == "vl_image":
            from PIL import Image
            img = Image.fromarray(np.random.default_rng(0).uniform(
                0, 255, (1024, 2048, 3)).astype("uint8"))
            out = e("describe\nthis", tar_lang="en", image=img, seed=3)
        else:
            out = e("a dog", tar_lang="en", seed=5)
    finally:
        srv.shutdown()
    return out, mock.requests


@pytest.mark.parametrize("case", ["text", "retry_then_success", "exhausted",
                                  "vl_image"])
def test_openai_compat_matches_jax(case):
    """The hosted client against the local mock server: status, prompt,
    seed and every request (path, auth, body with the image's data URL)
    equal to JAX's client's."""
    got, got_req = _hosted(tpe, case)
    want, want_req = _hosted(jpe, case)
    assert (got.status, got.prompt, got.seed) == (want.status, want.prompt,
                                                  want.seed)
    assert got_req == want_req
    n = {"retry_then_success": 3, "exhausted": 2}.get(case, 1)
    assert len(got_req) == n and got.status == (case != "exhausted")
    if case == "vl_image":
        parts = got_req[0]["body"]["messages"][-1]["content"]
        assert [p["type"] for p in parts] == ["text", "image_url"]


def test_transformers_expander_device_defaults_to_the_card(monkeypatch):
    """The local-model expander loads onto the card unless asked for the
    CPU: with no card it stops before loading anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = tpe.TransformersPromptExpander("/no/such/model")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e._load()
