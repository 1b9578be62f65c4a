"""Inmarsat STD-C parser module: .frm -> per-type JSON packet files.

Reference: plugins/inmarsat_support/stdc/{module_stdc_parser.cpp,
pkt_parser.cpp, msg_parser.cpp, egc_parser.cpp} — each 640-byte frame is a
sequence of descriptor-framed packets; 0x3D/0x3E multiframe packets are
reassembled and re-parsed; Message Data packets are accumulated per logical
channel and flushed 30 s after the last piece (clocked by Bulletin Board
frame timestamps); EGC double-header packets are accumulated per message
sequence number and flushed on the final part-2.

Counterpart of satdump_tpu/pipeline/modules/inmarsat/stdc_parser.py (host
NumPy, copied).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.pipeline.modules.inmarsat import stdc_pkts as pkts

FRAME_SIZE_BYTES = 640


class STDPacketParser:
    """pkt_parser.cpp:36-168 — walk one frame's packets."""

    def __init__(self, on_packet: Callable[[dict], None]):
        self.on_packet = on_packet
        self._mf_buf: Optional[bytearray] = None
        self._mf_got = 0

    def _mf_start(self, pkt: np.ndarray, pkt_len: int) -> None:
        mid = int(pkt[2])
        if mid >> 7 == 0:
            mlen = (mid & 0x0F) + 1
        elif mid >> 6 == 2:
            mlen = int(pkt[3]) + 2
        else:
            mlen = 0
        self._mf_buf = bytearray(mlen)
        self._mf_got = pkt_len - 4
        self._mf_buf[: self._mf_got] = pkt[2: 2 + self._mf_got].tobytes()

    def _mf_cont(self, pkt: np.ndarray, pkt_len: int) -> None:
        if self._mf_buf is None:
            return
        n = pkt_len - 4
        end = min(self._mf_got + n, len(self._mf_buf))
        self._mf_buf[self._mf_got: end] = \
            pkt[2: 2 + end - self._mf_got].tobytes()
        self._mf_got += n

    def parse_main_pkt(self, frame: np.ndarray, timestamp: float) -> None:
        frame = np.asarray(frame, np.uint8)
        n = len(frame)
        pos = 0
        while pos < n:
            pkt = frame[pos:]
            if int(pkt[0]) == 0x00:      # no more packets
                return
            desc = pkts.parse_descriptor(pkt)
            ptype, plen = desc["type"], desc["length"]
            out: dict = {}
            try:
                if ptype == pkts.FRM_MULTI_START:
                    self._mf_start(pkt, plen)
                elif ptype == pkts.FRM_MULTI_CONT:
                    self._mf_cont(pkt, plen)
                    if self._mf_buf is not None and \
                            self._mf_got == len(self._mf_buf) - 2:
                        inner = STDPacketParser(self.on_packet)
                        inner.parse_main_pkt(
                            np.frombuffer(bytes(self._mf_buf), np.uint8),
                            timestamp)
                    self._mf_buf = None
                    self._mf_got = 0
                elif ptype in pkts.PARSERS:
                    out = pkts.PARSERS[ptype](pkt, n - pos)
                else:
                    out = {"descriptor": desc}
            except pkts.PacketError as e:
                logger.debug(f"STD-C packet error at {pos}: {e}")
                out = {}
            if out:
                # first bulletin board anchors the frame's wall time
                if ptype == pkts.FRM_BULLETIN_BOARD and pos == 0:
                    day = timestamp - (timestamp % 86400)
                    timestamp = day + out["seconds_of_day"]
                out["timestamp"] = timestamp + (pos / n) * 8.64
                self.on_packet(out)
            if plen <= 0:
                return
            pos += plen


class MessageParser:
    """msg_parser.cpp — accumulate Message Data per logical channel; flush
    30 s of bulletin-board time after the last piece."""

    def __init__(self, on_message: Callable[[dict], None]):
        self.on_message = on_message
        self._wip: Dict[int, List[dict]] = {}

    def push_message(self, msg: dict) -> None:
        ch = msg["logical_channel_number"]
        self._wip.setdefault(ch, []).append(msg)
        self._wip[ch].sort(key=lambda m: m["packet_sequence_number"])

    def _flush(self, ch: int) -> None:
        parts = self._wip.pop(ch, [])
        if not parts:
            return
        final = dict(parts[-1])
        final["message"] = "".join(p["message"] for p in parts)
        final.pop("packet_sequence_number", None)
        final.pop("data", None)
        self.on_message(final)

    def push_current_time(self, now: float) -> None:
        for ch in list(self._wip):
            if now - self._wip[ch][-1]["timestamp"] > 30:
                self._flush(ch)

    def force_finish(self) -> None:
        for ch in list(self._wip):
            self._flush(ch)


class EGCMessageParser:
    """egc_parser.cpp — accumulate EGC double headers per message sequence
    number; flush on a non-continuation part 2."""

    def __init__(self, on_message: Callable[[dict], None]):
        self.on_message = on_message
        self._wip: Dict[int, List[dict]] = {}

    def push_message(self, msg: dict, is_p2: bool) -> None:
        mid = msg["message_sequence_number"]
        pno = msg["packet_sequence_number"]
        parts = self._wip.setdefault(mid, [])
        if any(p["packet_sequence_number"] == pno
               and p["_is_p2"] == is_p2 for p in parts):
            return
        m = dict(msg)
        m["_is_p2"] = is_p2
        parts.append(m)
        parts.sort(key=lambda p: p["packet_sequence_number"] * 2
                   + p["_is_p2"])
        if is_p2 and not msg["continuation"]:
            self._flush(mid)

    def _flush(self, mid: int) -> None:
        parts = self._wip.pop(mid, [])
        if not parts:
            return
        final = dict(parts[-1])
        final["message"] = "".join(p["message"] for p in parts)
        for k in ("packet_sequence_number", "data", "_is_p2"):
            final.pop(k, None)
        self.on_message(final)

    def force_finish(self) -> None:
        for mid in list(self._wip):
            self._flush(mid)


# Periodic test-loop message the reference drops (module_stdc_parser.cpp:135)
_TEST_LOOP = ("abcdefghijklmnopqrstuvwxyz1234567890"
              "ABCDEFGHIJKLMNOPQRSTUVWXYZ-!")


@register_module
class STDCParserModule(ProcessingModule):
    id = "inmarsat_stdc_parser"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.save_files = bool(self.param("save_files", True))
        self.station_id = str(self.param("station_id", ""))

    def _save(self, msg: dict, directory: str) -> None:
        self._npkts += 1
        if not self.save_files:
            return
        name = msg.get("pkt_name") or pkts.get_id_name(
            msg.get("descriptor", {}).get("type", -1))
        d = os.path.join(directory, name)
        os.makedirs(d, exist_ok=True)
        t = time.gmtime(msg.get("timestamp", 0.0))
        fname = time.strftime("%Y%m%dT%H%M%SZ", t)
        path = os.path.join(d, fname + ".json")
        i = 1
        while os.path.exists(path):
            path = os.path.join(d, f"{fname}_{i}.json")
            i += 1
        with open(path, "w") as f:
            json.dump(msg, f, indent=4, default=str)

    def process(self):
        directory = os.path.dirname(self.d_output_file_hint) or "."
        os.makedirs(directory, exist_ok=True)
        self.d_output_file = directory
        self._npkts = 0
        nmessages = [0]
        start_time = float(self.param("start_timestamp", 0) or time.time())

        msg_parser = MessageParser(lambda m: (
            m.__setitem__("pkt_name", "Full Message"),
            nmessages.__setitem__(0, nmessages[0] + 1),
            self._save(m, directory)))
        egc_parser = EGCMessageParser(lambda m: (
            m.__setitem__("pkt_name", "EGC Message"),
            nmessages.__setitem__(0, nmessages[0] + 1),
            self._save(m, directory)))

        def on_packet(msg: dict) -> None:
            pid = msg.get("descriptor", {}).get("type", -1)
            if pid == pkts.FRM_BULLETIN_BOARD:
                msg_parser.push_current_time(msg["timestamp"])
            if pid != pkts.FRM_MESSAGE_DATA:
                self._save(msg, directory)
            if pid == pkts.FRM_MESSAGE_DATA:
                if msg["message"] != _TEST_LOOP:
                    msg_parser.push_message(msg)
            elif pid == pkts.FRM_EGC_DOUBLE_1:
                egc_parser.push_message(msg, is_p2=False)
            elif pid == pkts.FRM_EGC_DOUBLE_2:
                egc_parser.push_message(msg, is_p2=True)

        parser = STDPacketParser(on_packet)
        data = np.fromfile(self.d_input_file, np.uint8)
        nfrm = len(data) // FRAME_SIZE_BYTES
        for i in range(nfrm):
            frame = data[i * FRAME_SIZE_BYTES: (i + 1) * FRAME_SIZE_BYTES]
            try:
                parser.parse_main_pkt(frame, start_time)
            except Exception as e:          # mirror the reference's catch-all
                logger.error(f"Error processing STD-C frame {e}")
        msg_parser.force_finish()
        egc_parser.force_finish()
        self.stats = {"frames": nfrm, "packets": self._npkts,
                      "messages": nmessages[0]}
        logger.info(f"STD-C parser: {nfrm} frames, {self._npkts} packets, "
                    f"{nmessages[0]} messages")
