"""End-to-end serving demo on ``diffus_tpu_torch``: spin up the HTTP runtime,
drive it as a client (the port of ``examples/serve_client.py``, same
arguments, defaults and output lines).

Starts a RendererService on a phantom volume, serves it over HTTP on an
ephemeral port, renders a pose batch through the wire protocol, recovers a
pose over the wire, swaps the volume, stages and routes to a second scene,
and prints latency + stats — the whole serving surface in one script.

    python examples/torch/serve_client.py --device cpu --size 48
    python examples/torch/serve_client.py --size 256 --rays 256 --samples 512 \\
        --pallas --interp trilinear_fused

Runs on ``--device`` (default ``cuda``; without a card it stops and says to
pass ``--device cpu``).  ``--pallas`` runs the echo scan through kernel K1
(and ``/recover``'s backward through K1b), ``--interp trilinear`` (or
``trilinear_fused``) the service's sampler through K2; ``/recover`` renders
with ``trilinear``, through K2 and K2b, whatever the service's interp.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json
import threading
import time
import urllib.request

import numpy as np

INTERPS = ["nearest", "trilinear", "trilinear_bf16", "trilinear_fused"]


def post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def decode_frames(payload: dict) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(payload["npy_b64"])))


def npy_b64(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode()


def make_service(d: int, rays: int, samples: int, interp: str = "nearest",
                 pallas: bool = False, device="cpu"):
    """The demo's service: the brain phantom at ``d``^3, batch tiers (1, 4)."""
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    return RendererService(
        brain_phantom_3d((d, d, d)),
        BeamGeometry(n_rays=rays, num_samples=samples),
        RenderConfig(attenuation_coeff=1e-4, interp=interp, use_pallas=pallas),
        batch_tiers=(1, 4), device=device,
    )


def request_sources(d: int) -> np.ndarray:
    """The 4 poses of the demo's ``/render`` requests."""
    rng = np.random.default_rng(0)
    return (
        np.array([d / 2, 2.0, d / 2], np.float32)[None]
        + rng.uniform(-3, 3, (4, 3)).astype(np.float32)
    )


def recovery_target(svc, true: np.ndarray) -> np.ndarray:
    """The frame ``/recover`` is asked to place: rendered at ``true`` with
    the service's config on ``trilinear``, the interpolating sampler its
    recovery renders with (K2 on the card)."""
    import torch

    from diffus_tpu_torch.train.pose_recovery import AnnealedPoseConfig, render_pose
    from diffus_tpu_torch.types import TransducerPose

    cfg = AnnealedPoseConfig(
        geometry=svc.geometry,
        render=dataclasses.replace(svc.config, interp="trilinear"),
    )
    with torch.no_grad():
        target = render_pose(svc.volume, TransducerPose.create(true, device=svc.device),
                             cfg.as_base())
    return target.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--rays", type=int, default=64)
    ap.add_argument("--samples", type=int, default=96)
    ap.add_argument("--interp", default="nearest", choices=INTERPS,
                    help="sampler (trilinear, trilinear_fused: the CUDA kernel K2 on the card)")
    ap.add_argument("--pallas", action="store_true",
                    help="run the echo scan through the CUDA kernel (K1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu where there is no card)")
    args = ap.parse_args(argv)
    from diffus_tpu_torch.cli import _device
    from diffus_tpu_torch.phantoms import t1_phantom_3d
    from diffus_tpu_torch.serve import make_http_server

    device = _device(args)
    d = args.size
    svc = make_service(d, args.rays, args.samples, args.interp, args.pallas, device)
    warm = svc.warmup()
    server = make_http_server(svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    print(f"serving at {url} (warmup {warm:.2f}s)")

    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        assert json.load(r)["ok"]

    sources = request_sources(d)
    t0 = time.perf_counter()
    frames = decode_frames(post(f"{url}/render", {"sources": sources.tolist()}))
    ms = (time.perf_counter() - t0) * 1e3
    print(f"rendered {frames.shape} over the wire in {ms:.1f} ms")

    # pose recovery over the wire: where was this frame taken from?
    # (run against the impedance-like brain phantom — a volume with
    # zero-impedance regions has NaN reflection GRADIENTS and /recover
    # would refuse with a pointer to the impedance mapping)
    true = np.array([d / 2, 2.0, d / 2], np.float32)
    target = recovery_target(svc, true)
    t0 = time.perf_counter()
    rec = post(f"{url}/recover", {
        "target_npy_b64": npy_b64(target),
        "init_position": (true + [1.0, -0.5, 0.8]).tolist(),
        "count": 4, "radius": 1.0, "rot_scale": 0.0,
        "phases": [[1.0, 0.2, 0.0, 60], [0.0, 0.1, 0.0, 90]],
    })
    err = float(np.linalg.norm(np.array(rec["position"]) - true))
    print(f"recovered pose over the wire in "
          f"{time.perf_counter() - t0:.1f}s: {rec['position']} "
          f"(err {err:.3f} vox, loss {rec['final_loss']:.2e})")

    # case swap: new volume, no recompile, renders change
    post(f"{url}/update_volume", {"npy_b64": npy_b64(t1_phantom_3d((d, d, d)))})
    frames2 = decode_frames(post(f"{url}/render", {"sources": sources.tolist()}))
    changed = not np.allclose(frames, frames2)
    print(f"volume swapped; frames changed: {changed}")

    # multi-scene: stage a second resident case over the wire (the
    # reference's per-case REUBEN workflow) and route requests to it
    post(f"{url}/add_scene",
         {"name": "case_b", "npy_b64": npy_b64(np.roll(svc.volume.cpu().numpy(), d // 4, axis=1))})
    with urllib.request.urlopen(f"{url}/scenes", timeout=30) as r:
        print("resident scenes:", json.load(r))
    frames_b = decode_frames(post(
        f"{url}/render", {"sources": sources.tolist(), "scene": "case_b"}
    ))
    print(f"scene routing works: case_b frames differ: "
          f"{not np.allclose(frames2, frames_b)}")
    post(f"{url}/remove_scene", {"name": "case_b"})

    with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
        print("stats:", json.load(r))
    server.shutdown()
    server.server_close()
    print("serve client demo OK")


if __name__ == "__main__":
    main()
