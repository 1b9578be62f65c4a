"""The port's network frame modules (`network_server`, `network_client`)
and their transport (`io/net.py`) against the JAX package's, on localhost:
each package's server feeds the other's client (the wire is the same), in
the framed-TCP and the UDP modes, and `dvbs2_test` sends a .ts file's
packets through the port's CLI. The bytes received equal the bytes sent.
"""

import socket
import threading

import numpy as np
import pytest

from satdump_tpu.io import net as jnet
from satdump_tpu.pipeline.modules import network as jn
from satdump_tpu_torch import cli
from satdump_tpu_torch.io import net as tnet
from satdump_tpu_torch.pipeline.modules import network as tn


def _free_port(kind=socket.SOCK_STREAM) -> int:
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("srv_net,cli_net", [(tnet, jnet), (jnet, tnet),
                                             (tnet, tnet)])
def test_framed_tcp_interop(srv_net, cli_net):
    srv = srv_net.FramedTCPServer(0)
    got = []

    def client():
        c = cli_net.FramedTCPClient("127.0.0.1", srv.port)
        got.append(c.recv())
        c.send(b"pong" * 300)
        c.close()

    t = threading.Thread(target=client)
    t.start()
    srv.wait_client(timeout=5)
    srv.send(b"ping")
    assert srv.recv() == b"pong" * 300
    t.join(timeout=5)
    assert got == [b"ping"]
    srv.close()


def test_framed_tcp_refuses_a_second_client():
    srv = tnet.FramedTCPServer(0)
    first = []
    t = threading.Thread(target=lambda: first.append(
        tnet.FramedTCPClient("127.0.0.1", srv.port)))
    t.start()
    srv.wait_client(timeout=5)
    t.join(timeout=5)
    t = threading.Thread(target=srv.wait_client, kwargs={"timeout": 5})
    t.start()
    with pytest.raises(ConnectionRefusedError):
        jnet.FramedTCPClient("127.0.0.1", srv.port)
    t.join(timeout=5)
    first[0].close()
    srv.close()


@pytest.mark.parametrize("srv_mod,cli_mod", [(tn, jn), (jn, tn), (tn, tn)])
def test_network_modules_tcp(tmp_path, srv_mod, cli_mod, rng):
    """frames file -> network_server (framed TCP) -> network_client: the
    .frm holds the file's frames, in either package's pairing."""
    frames = rng.integers(0, 256, 1024 * 20, dtype=np.uint8)
    src = tmp_path / "in.cadu"
    frames.tofile(src)
    port = _free_port()
    srv = srv_mod.NetworkServerModule(str(src), str(tmp_path / "srv"),
                                      {"server_port": port, "pkt_size": 1024})
    rx = cli_mod.NetworkClientModule("", str(tmp_path / "cli"),
                                     {"client_port": port, "pkt_size": 1024})
    t = threading.Thread(target=srv.process)
    t.start()
    rx.process()
    t.join(timeout=10)
    np.testing.assert_array_equal(np.fromfile(rx.d_output_file, np.uint8),
                                  frames)
    assert srv.stats == {"packets_sent": 20}
    assert rx.stats == {"packets_received": 20}


@pytest.mark.parametrize("rx_net", [tnet, jnet])
def test_network_server_udp_send(tmp_path, rx_net, rng):
    frames = rng.integers(0, 256, (12, 188), dtype=np.uint8)
    src = tmp_path / "in.ts"
    frames.tofile(src)
    rx = rx_net.UDPFrameReceiver(0, timeout=5.0)
    srv = tn.NetworkServerModule(str(src), str(tmp_path / "srv"), {
        "server_mode": "udp_send", "server_port": rx.port, "pkt_size": 188})
    srv.process()
    got = [rx.recv(188) for _ in range(12)]
    rx.close()
    assert srv.stats == {"packets_sent": 12}
    assert b"".join(got) == frames.tobytes()


def test_cli_dvbs2_test_from_ts(tmp_path, rng):
    """dvbs2_test's last level: the .ts file's 1316-byte groups of seven TS
    packets go out as UDP datagrams to the port given on the CLI."""
    ts = rng.integers(0, 256, (70, 188), dtype=np.uint8)
    ts[:, 0] = 0x47
    src = tmp_path / "in.ts"
    ts.tofile(src)
    rx = tnet.UDPFrameReceiver(0, timeout=5.0)
    assert cli.main(["pipeline", "dvbs2_test", "ts", str(src),
                     str(tmp_path / "out"), "--torch_device", "cpu",
                     "--server_port", str(rx.port)]) == 0
    got = [rx.recv(1316) for _ in range(10)]
    rx.close()
    assert b"".join(got) == ts.tobytes()
