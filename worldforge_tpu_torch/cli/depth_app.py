"""Interactive DepthCrafter demo: a stdlib HTTP app.

Counterpart of ``worldforge_tpu/cli/depth_app.py`` (the equivalent of
DepthCrafter's gradio ``app.py``, with no dependency beyond the standard
library's ``http.server``). The form has the reference's controls: denoising
steps (1-25, default 5), cfg scale (1.0-1.2, default 1.0), max resolution
(512-2048, default 1024), process length (-1..280, default 60) and target
FPS (default 15). A run writes the resized input video, the
inferno-coloured depth video (``utils/depth_vis.py``) and the raw depth
``.npz`` under ``--output-dir`` and shows them on one result page; the
``/files/`` route serves them.

The model loads once at start-up on ``--device`` (the card unless
``--device cpu``): ``--checkpoint-dir`` holds converted DepthCrafter weights
(``io/convert_depthcrafter.py``), or ``--random-init`` draws them (full width,
or ``--tiny``) from generators on the device seeded 0 (UNet, bf16) and 1
(VAE, fp32).

    python -m worldforge_tpu_torch.cli.depth_app --random-init --port 7860

then open http://127.0.0.1:7860/.
"""

from __future__ import annotations

import argparse
import html
import json
import os
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_FORM = """<!doctype html><html><head><title>DepthCrafter (worldforge)</title>
<style>body{{font-family:sans-serif;max-width:46em;margin:2em auto}}
label{{display:block;margin-top:.8em}}input{{width:100%}}</style></head>
<body><h1>DepthCrafter: consistent long depth sequences</h1>
<p>PyTorch port; reference demo: DepthCrafter/app.py. Model: {model}</p>
<form method="post" action="/run">
<label>Video path (file or frame dir, on this host)
<input name="video" value="{video}"></label>
<label>num denoising steps (1-25) <input name="steps" value="5"></label>
<label>cfg scale (1.0-1.2) <input name="cfg" value="1.0"></label>
<label>max resolution (512-2048) <input name="max_res" value="1024"></label>
<label>process length (-1 = all, max 280) <input name="length" value="60"></label>
<label>target FPS (-1 = keep) <input name="fps" value="15"></label>
<p><button type="submit">Generate</button> (runs on {device}; the first
call includes the kernels' start-up)</p></form>{extra}</body></html>"""

_RESULT = """<!doctype html><html><head><title>Depth result</title></head>
<body style="font-family:sans-serif;max-width:60em;margin:2em auto">
<h1>Depth result ({secs:.1f} s)</h1>
<table><tr><td><h3>Preprocessed input</h3>
<video src="/files/{tag}_input.mp4" controls autoplay loop muted width="440">
</video></td>
<td><h3>Generated depth</h3>
<video src="/files/{tag}_vis.mp4" controls autoplay loop muted width="440">
</video></td></tr></table>
<p>Raw depth: <a href="/files/{tag}_depth.npz">{tag}_depth.npz</a></p>
<p><a href="/">back</a></p></body></html>"""


def _build_pipeline(args):
    from worldforge_tpu_torch.core.dtypes import resolve_device
    dev = resolve_device(args.device)
    if args.random_init:
        import torch

        from worldforge_tpu_torch.models.depthcrafter.unet import (
            SVDUNetConfig, init_svd_unet)
        from worldforge_tpu_torch.models.depthcrafter.vae import (
            SVDVAEConfig, init_svd_vae)
        from worldforge_tpu_torch.pipelines.depthcrafter import \
            DepthCrafterPipeline
        ucfg = (SVDUNetConfig.tiny() if args.tiny else SVDUNetConfig.svd())
        vcfg = (SVDVAEConfig.tiny() if args.tiny else SVDVAEConfig.svd())
        gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
        return DepthCrafterPipeline(
            init_svd_unet(gen(0), ucfg, dtype=torch.bfloat16), ucfg,
            init_svd_vae(gen(1), vcfg, dtype=torch.float32), vcfg)
    from worldforge_tpu_torch.io.convert_depthcrafter import \
        load_converted_depthcrafter
    return load_converted_depthcrafter(args.checkpoint_dir, device=dev)


def make_handler(pipe, args):
    import torch

    from worldforge_tpu_torch.io.frames import export_video, load_frames
    from worldforge_tpu_torch.models.depthcrafter.inference import \
        resize_to_64
    from worldforge_tpu_torch.pipelines.depthcrafter import normalize_depth
    from worldforge_tpu_torch.utils.depth_vis import vis_sequence_depth

    outdir = os.path.abspath(args.output_dir)
    os.makedirs(outdir, exist_ok=True)

    class Handler(BaseHTTPRequestHandler):
        def _page(self, body: str, code: int = 200):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.startswith("/files/"):
                name = os.path.basename(urllib.parse.unquote(
                    self.path[len("/files/"):]))
                path = os.path.join(outdir, name)
                if not os.path.isfile(path):
                    return self._page("not found", 404)
                ctype = ("video/mp4" if name.endswith(".mp4")
                         else "application/octet-stream")
                with open(path, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            model = ("random-init (smoke)" if args.random_init
                     else args.checkpoint_dir)
            self._page(_FORM.format(model=html.escape(str(model)),
                                    video=html.escape(args.example or ""),
                                    device=html.escape(str(pipe.device)),
                                    extra=""))

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            form = urllib.parse.parse_qs(self.rfile.read(length).decode())
            get = lambda k, d: form.get(k, [d])[0]
            video = get("video", "")
            try:
                steps = max(1, min(25, int(get("steps", "5"))))
                cfg = min(1.2, max(1.0, float(get("cfg", "1.0"))))
                max_res = max(64, min(2048, int(get("max_res", "1024"))))
                proc_len = int(get("length", "60"))
                fps = int(get("fps", "15"))
                frames = load_frames(video)
            except Exception as e:  # bad path/params -> back to the form
                return self._page(_FORM.format(
                    model="", video=html.escape(video),
                    device=html.escape(str(pipe.device)),
                    extra=f"<p style='color:red'>{html.escape(str(e))}</p>"))
            if proc_len > 0:
                frames = frames[:proc_len]
            frames = resize_to_64(frames, max_res)

            t0 = time.perf_counter()
            gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
            out = pipe(gen, frames,
                       num_inference_steps=steps, guidance_scale=cfg,
                       window_size=args.window_size, overlap=args.overlap)
            depth = normalize_depth(out)
            secs = time.perf_counter() - t0

            tag = time.strftime("%H%M%S")
            export_video(list(frames), os.path.join(
                outdir, f"{tag}_input.mp4"), fps=max(fps, 1))
            export_video(list(vis_sequence_depth(depth)), os.path.join(
                outdir, f"{tag}_vis.mp4"), fps=max(fps, 1))
            np.savez(os.path.join(outdir, f"{tag}_depth.npz"), depth=depth)
            self._page(_RESULT.format(tag=tag, secs=secs))

        def log_message(self, fmt, *a):  # quiet
            pass

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="tiny configs (CPU tests)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the model; default the CUDA card "
                        "(fails without one)")
    p.add_argument("--output-dir", type=str, default="depth_app_out")
    p.add_argument("--window-size", type=int, default=110)
    p.add_argument("--overlap", type=int, default=25)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--example", type=str, default=None,
                   help="prefill the video-path box")
    p.add_argument("--once", action="store_true",
                   help="serve a single request then exit (tests)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not args.random_init and not args.checkpoint_dir:
        raise SystemExit("pass --checkpoint-dir (converted weights) or "
                         "--random-init")
    pipe = _build_pipeline(args)
    srv = ThreadingHTTPServer((args.host, args.port),
                              make_handler(pipe, args))
    print(f"DepthCrafter demo: http://{args.host}:{srv.server_address[1]}/",
          flush=True)
    if args.once:
        srv.handle_request()
        srv.handle_request()
        return
    srv.serve_forever()


if __name__ == "__main__":
    main()
