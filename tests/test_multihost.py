"""Multi-HOST (multi-process) rendering: the real scripts/run_multihost.py
flow — jax.distributed.initialize + global mesh + cross-process collectives —
executed as 2 local CPU processes of 4 virtual devices each (gloo over
localhost standing in for the network between hosts). This is the closest
a single machine gets to several GPU hosts; only the transport differs."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "run_multihost.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_render_matches_single(tmp_path):
    """Transport must not change numerics (round-5 VERDICT #6): the SAME
    (2, 4) global mesh rendered by 2 processes x 4 devices (gloo standing in
    for the host network) and by 1 process x 8 devices must be BIT-IDENTICAL — per-device
    keys derive from mesh position, never from process layout. The old
    whole-image channel-mean check stays as a sanity reference against the
    unsharded renderer (different sampling, statistical only)."""
    out = str(tmp_path / "mh.png")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [
                sys.executable, SCRIPT, "--scene", "quads", "--spp", "8",
                "--width", "96", "--out", out,
                "--coordinator", f"localhost:{port}",
                "--num-processes", "2", "--process-id", str(pid),
                "--local-devices", "4", "--sample-parallel", "4",
            ],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=280)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert os.path.exists(out), outs

    import imageio.v3 as iio

    from raytracer_tpu.parallel.mesh import make_mesh
    from raytracer_tpu.parallel.shard import render_image_sharded
    from raytracer_tpu.render.driver import render_image
    from raytracer_tpu.render.postprocess import to_u8
    from raytracer_tpu.scenes.registry import get_scene

    mh = iio.imread(out)
    scene, cam, settings = get_scene("quads", spp=8, width=96)

    # 1 process x 8 virtual devices, SAME (2, 4) mesh shape: per-pixel
    # bit identity with the 2-process render.
    mesh = make_mesh(8, sample_parallel=4)
    single = np.asarray(
        to_u8(render_image_sharded(scene, cam, settings, mesh, seed=0))
    )
    np.testing.assert_array_equal(mh, single)

    # Statistical sanity vs the unsharded renderer (different sampling).
    ref = np.asarray(
        to_u8(render_image(scene, cam, settings, seed=0, regenerative=False))
    ).astype(np.float32) / 255.0
    np.testing.assert_allclose(
        mh.astype(np.float32).mean((0, 1)) / 255.0,
        ref.mean((0, 1)),
        atol=0.03,
    )
