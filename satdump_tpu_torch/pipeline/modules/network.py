"""Network frame server/client modules.

Reference: src-core/pipeline/modules/network/module_network_server.cpp:58-100
(nng pub / udp_send of pkt_size frames) and module_network_client.cpp. The
TCP mode here uses this framework's framed transport (io/net.py) where the
reference uses nng pub/sub; UDP mode is datagram-per-frame like the
reference's "udp_send". A copy of
satdump_tpu/pipeline/modules/network.py; it takes no device.
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.io.net import (FramedTCPClient, FramedTCPServer,
                                      UDPFrameReceiver, UDPFrameSender)
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module


@register_module
class NetworkServerModule(ProcessingModule):
    id = "network_server"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.mode = str(self.param("server_mode", "default"))
        self.address = str(self.param("server_address", "127.0.0.1"))
        self.port = int(self.param("server_port", required=True))
        self.pkt_size = int(self.param("pkt_size", required=True))
        self.client_wait_s = float(self.param("client_wait_s", 10.0))

    def process(self):
        data = np.fromfile(self.d_input_file, np.uint8)
        npkts = len(data) // self.pkt_size
        sent = 0
        if self.mode == "udp_send":
            tx = UDPFrameSender(self.address, self.port)
            for i in range(npkts):
                tx.send(data[i * self.pkt_size:(i + 1) * self.pkt_size]
                        .tobytes())
                sent += 1
            tx.close()
        else:
            srv = FramedTCPServer(self.port, self.address)
            try:
                srv.wait_client(timeout=self.client_wait_s)
                for i in range(npkts):
                    srv.send(data[i * self.pkt_size:(i + 1) * self.pkt_size]
                             .tobytes())
                    sent += 1
                srv.send(b"")
            finally:
                srv.close()
        self.d_output_file = self.d_input_file
        self.stats = {"packets_sent": sent}
        logger.info(f"network_server: sent {sent} packets of {self.pkt_size}")


@register_module
class NetworkClientModule(ProcessingModule):
    id = "network_client"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.mode = str(self.param("client_mode", "default"))
        self.address = str(self.param("client_address", "127.0.0.1"))
        self.port = int(self.param("client_port", required=True))
        self.pkt_size = int(self.param("pkt_size", required=True))
        self.timeout = float(self.param("timeout_s", 5.0))
        self.max_packets = int(self.param("max_packets", 0))

    def process(self):
        out_path = self.d_output_file_hint + ".frm"
        self.d_output_file = out_path
        got = 0
        with open(out_path, "wb") as f:
            if self.mode == "udp":
                rx = UDPFrameReceiver(self.port, self.address, self.timeout)
                while True:
                    pkt = rx.recv(self.pkt_size)
                    if pkt is None:
                        break
                    f.write(pkt)
                    got += 1
                    if self.max_packets and got >= self.max_packets:
                        break
                rx.close()
            else:
                c = FramedTCPClient(self.address, self.port, self.timeout)
                while True:
                    pkt = c.recv()
                    if not pkt:
                        break
                    f.write(pkt)
                    got += 1
                    if self.max_packets and got >= self.max_packets:
                        break
                c.close()
        self.stats = {"packets_received": got}
        logger.info(f"network_client: received {got} packets")
