"""The port's interactive viewer under a real pseudo-terminal: `cli view
--device cpu` renders ANSI half-block frames, steps through
`Renderer.step_n` between key polls, and quits on ``q`` (as
tests/test_viewer_pty.py holds the JAX package's viewer)."""

import os
import pty
import re
import select
import subprocess
import sys
import time

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_port_viewer_renders_a_frame_and_quits():
    # (hang-safety is the in-test deadline + proc.kill, not a marker)
    master, slave = pty.openpty()
    # One intra-op thread: the plain tracer's passes are many small
    # operations, which threads slow down when the test workers share the
    # cores, and a pass must stay under half the viewer's 100 ms poll
    # target for the chunk to grow.
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpu_bidirectional_raytracer_tpu_torch.cli",
         "--device", "cpu", "view",
         os.path.join(REPO, "assets", "scenes", "simple.scn"),
         "--width", "16", "--height", "12", "--mode", "cpu"],
        stdin=slave, stdout=slave, stderr=subprocess.DEVNULL,
        env=env, cwd=REPO)
    os.close(slave)

    out = b""
    deadline = time.time() + 150
    sent_quit = False
    saw_chunked = False
    try:
        while time.time() < deadline:
            r, _, _ = select.select([master], [], [], 1.0)
            if r:
                try:
                    chunk = os.read(master, 65536)
                except OSError:
                    break
                if not chunk:
                    break
                out += chunk
            # The adaptive chunking engages once the viewer has a per-pass
            # estimate: the status line reports the poll chunk. Quit after
            # chunked stepping is observed (or after the first frame once
            # 60 s have passed).
            if not saw_chunked:
                saw_chunked = any(
                    int(m) > 1
                    for m in re.findall(rb"\(x(\d+)/poll\)", out))
            if not sent_quit and b"pass " in out and (
                    saw_chunked or time.time() > deadline - 90):
                os.write(master, b"q")
                sent_quit = True
            if proc.poll() is not None:
                break
        proc.wait(timeout=30)
    finally:
        os.close(master)
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    assert sent_quit, f"viewer never printed a frame: {out[-300:]!r}"
    assert proc.returncode == 0, (proc.returncode, out[-300:])
    # ANSI half-block frame content made it to the terminal
    assert b"\x1b[H" in out
    assert "▀".encode() in out
    # The adaptive chunk engaged (step_n between key polls): on a
    # CPU-golden 16x12 render one pass is well under the 100 ms poll
    # target, so the chunk must have exceeded 1 before the quit.
    assert saw_chunked, out[-500:]
