"""The port's live two-process transmitter -> receiver link over TCP.

The reference's only multi-node deployment is the USRP RF pair
(examples/transmitter.grc, receiver.grc): the transmitter radiates
continuously; a receiver tunes in mid-stream and must acquire frame sync
from an arbitrary symbol offset. ``tests/test_socket_link.py``'s cases on
the port's blocks and app, with the port's own flowgraphs
(``gr_ldpc_ece535a_torch/flowgraphs/``) on the repository's
``examples/test.bmp``. Every connect, receive loop and process wait has
its own time limit.
"""

import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from gr_ldpc_ece535a_torch.blocks import TcpBroadcastSink, TcpSource

REPO = Path(__file__).resolve().parents[1]
FLOWGRAPHS = REPO / "gr_ldpc_ece535a_torch" / "flowgraphs"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_tcp_blocks_roundtrip_and_midstream_join():
    """Items sent with no listener are dropped (the radio-carrier
    behavior); a client that connects later receives exactly the items sent
    after it joined, and sees EOF when the transmitter closes."""
    port = _free_port()
    sink = TcpBroadcastSink(port=port, dtype=np.complex64)
    sink.start()
    try:
        sink.work((np.arange(64) + 0j).astype(np.complex64))  # into the void
        src = TcpSource(port=port, dtype=np.complex64, connect_timeout=5.0)
        src.start()
        time.sleep(0.05)  # let the accept queue deliver the connection
        sent = (np.arange(256) - 128 + 0.5j).astype(np.complex64)
        sink.work(sent[:100])
        sink.work(sent[100:])
        got = []
        deadline = time.monotonic() + 5.0
        while sum(len(g) for g in got) < len(sent):
            _, out = src.work(None)
            if out is not None and len(out):
                got.append(out)
            if time.monotonic() > deadline:
                pytest.fail("tcp source did not receive the stream")
            time.sleep(0.01)
        np.testing.assert_array_equal(np.concatenate(got), sent)
    finally:
        sink.stop()
    deadline = time.monotonic() + 5.0
    while not src.done and time.monotonic() < deadline:
        src.work(None)
        time.sleep(0.01)
    assert src.done
    src.stop()


def test_tcp_source_gives_up_without_a_transmitter():
    src = TcpSource(port=_free_port(), connect_timeout=0.3)
    with pytest.raises(ConnectionError, match="no transmitter"):
        src.start()


def _app(*args):
    return [sys.executable, "-m", "gr_ldpc_ece535a_torch.apps.ldpc_flowgraph",
            *args, "--device", "cpu"]


# each process on one intra-op thread: the suite runs several workers on
# one machine's cores
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def test_live_two_process_transmitter_receiver(tmp_path):
    """transmitter.yaml and receiver.yaml as two processes of the port's
    ldpc_flowgraph app over localhost: the transmitter streams the encoded
    image through a noisy channel model until it is stopped; the receiver
    joins mid-stream, takes five images' worth of symbols, and must
    reassemble the image, byte for byte."""
    port = _free_port()
    out_path = tmp_path / "result.bmp"
    symbols = 5 * len((REPO / "examples" / "test.bmp").read_bytes()) * 16
    tx = subprocess.Popen(
        _app(str(FLOWGRAPHS / "transmitter.yaml"), "-p", f"tx.port={port}",
             "-p", "src.repeats=3000"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=ENV)
    rx = None
    try:
        deadline = time.monotonic() + 60.0
        while True:   # the transmitter is up once its socket accepts
            try:
                socket.create_connection(("127.0.0.1", port), 0.2).close()
                break
            except OSError:
                if tx.poll() is not None:
                    pytest.fail(f"transmitter died early:\n"
                                f"{tx.communicate(timeout=10)[1][-800:]}")
                if time.monotonic() > deadline:
                    pytest.fail("transmitter never opened its socket")
                time.sleep(0.1)
        time.sleep(0.5)  # symbols radiated into the void: a mid-stream join
        rx = subprocess.Popen(
            _app(str(FLOWGRAPHS / "receiver.yaml"), "-p", f"rx.port={port}",
                 "-p", "rx.connect_timeout=60", "-p",
                 f"rx.max_items={symbols}", "-p",
                 f"sink.out_path={out_path}", "-p", "sink.verbose=false"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=ENV)
        out, err = rx.communicate(timeout=180)
        assert rx.returncode == 0, err[-1500:]
        assert tx.poll() is None, "the transmitter stopped before the receiver"
    finally:
        for p in (tx, rx):
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate()
    assert re.search(r"IN SYNC", out), out
    written = int(re.search(r"sink: images_written=(\d+)", out).group(1))
    assert written >= 1, out
    assert out_path.read_bytes() == (REPO / "examples" / "test.bmp").read_bytes()
