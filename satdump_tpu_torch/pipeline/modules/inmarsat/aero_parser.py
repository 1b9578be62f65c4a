"""Inmarsat Aero parser module: .frm (signal units) -> JSON packet files.

Reference: plugins/inmarsat_support/aero/{module_aero_parser.cpp,
pkt_structs.cpp, acars_parser.cpp} — 12-byte signal units with a CCITT-16
(0x8408 reflected) checksum; User Data ISU (0x71) + SSU chains reassemble
into payloads; ACARS payloads (0xFF 0xFF lead-in) are parsed into
mode/tag/label/plane-reg/text. The libacars application-layer decode and
the AMBE voice synthesis (mbelib) are out of scope; C-channel voice bytes
are saved raw as .ambe alongside the block data.

Counterpart of satdump_tpu/pipeline/modules/inmarsat/aero_parser.py (host
NumPy, copied).
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module

SU_SIZE = 12

PKT_NAMES = {
    0x00: "Reserved 0x00", 0x01: "Fill-in Signal Unit",
    0x02: "AES System Table Broadcast (GES Psmc and Rsmc channels PARTIAL)",
    0x03: "AES System Table Broadcast (Beam Identification PARTIAL)",
    0x04: "AES System Table Broadcast (GES Beam Support PARTIAL)",
    0x05: "AES System Table Broadcast (GES Psmc and Rsmc channels COMPLETE)",
    0x06: "AES System Table Broadcast (Beam Identification COMPLETE)",
    0x07: "AES System Table Broadcast (GES Beam Support COMPLETE)",
    0x08: "System Broadcast Selective Release",
    0x09: "System Broadcast Universal Time",
    0x0A: "AES System Table Broadcast (Index)",
    0x0B: "AES System Table Broadcast (Satellite Identification PARTIAL)",
    0x0C: "AES System Table Broadcast (Satellite Identification COMPLETE)",
    0x0D: "AES System Table Broadcast (2nd Series Of GES Psmc and Rsmc"
          " channels COMPLETE)",
    0x10: "Log-On Request", 0x11: "Log-On Confirm",
    0x12: "Log Control (P Channel) Log-Off Request",
    0x13: "Log Control (P Channel) Log-On Reject",
    0x14: "Log Control (P Channel) Log-On Interrogation",
    0x15: "Log-On Log-Off Acknowledge (P Channel)",
    0x16: "Log Control (P Channel) Log-On Prompt",
    0x17: "Log Control (P Channel) Data Channel Reassignment",
    0x20: "General Access Request Telephone / Call Annoucement",
    0x21: "Call Information Service Address",
    0x22: "Acess Request Data (R/T Channel)",
    0x23: "Abreviated Access Request Telephone",
    0x28: "Data EIRP Table Broadcast COMPLETE",
    0x29: "Data EIRP Table Broadcast PARTIAL",
    0x30: "Call Progress", 0x31: "C Channel Assignment Distress",
    0x32: "C Channel Assignment Flight Safety",
    0x33: "C Channel Assignment Other Safety",
    0x34: "C Channel Assignment Non Safety",
    0x40: "P/R Channel Control (ISU)", 0x41: "T Channel Control (ISU)",
    0x50: "Unsolicited Reservation", 0x51: "T Channel Assignment",
    0x53: "Reservation Forthcoming (RFC)",
    0x60: "Telephony Acknowledge (P/C or R Channel)",
    0x61: "Request For Acknowledgement (RQA) (P Channel)",
    0x62: "Acknowledge (RACK / TACK P Channel, PACK R Channel)",
    0x71: "User Data (ISU) RLS (P/T Channel)",
    0x72: "Retransmission Header (RTX) (P/T Channel)",
    0x74: "User Data (3 Octet LSDU) RLS (P/T Channel)",
    0x76: "User Data (4 Octet LSDU) RLS (P/T Channel)",
    0x80: "Broadcast Reserved",
    0x85: "AES System Table Broadcat Spot Beam Series Index",
}


def pkt_type_to_name(pid: int) -> str:
    if pid in PKT_NAMES:
        return PKT_NAMES[pid]
    if (pid & 0xC0) == 0xC0:
        return "SSU"
    if pid in (0x0E, 0x18, 0x19, 0x24, 0x25, 0x26, 0x27, 0x35, 0x36, 0x37,
               0x38, 0x39, 0x52, 0x63, 0x64, 0x65, 0x70, 0x73, 0x75, 0x89):
        return f"Reserved 0x{pid:02X}"
    return "Unknown"


def compute_crc(buf: np.ndarray, n: int) -> int:
    """Reflected CCITT-16, poly 0x8408, init 0xFFFF, xorout 0xFFFF
    (pkt_structs.cpp:200-216)."""
    crc = 0xFFFF
    for i in range(n):
        b = int(buf[i])
        for _ in range(8):
            bit = (b ^ crc) & 1
            b >>= 1
            crc >>= 1
            if bit:
                crc ^= 0x8408
    return crc ^ 0xFFFF


def check_crc(pkt: np.ndarray) -> bool:
    return compute_crc(pkt, 10) == (int(pkt[11]) << 8 | int(pkt[10]))


def append_crc(body10: bytes) -> bytes:
    """TX helper: 10 bytes -> 12-byte signal unit."""
    crc = compute_crc(np.frombuffer(body10, np.uint8), 10)
    return body10 + bytes([crc & 0xFF, crc >> 8])


def is_acars_data(payload: np.ndarray) -> bool:
    return len(payload) > 16 and payload[0] == 0xFF and payload[1] == 0xFF


class ACARSPacket:
    """acars_parser.cpp:20-67 (odd-parity 7-bit chars)."""

    def __init__(self, pkt: np.ndarray):
        self.mode = int(pkt[3]) & 0x7F
        self.tak = chr(int(pkt[11]) & 0x7F)
        self.label = chr(int(pkt[12]) & 0x7F) + chr(int(pkt[13]) & 0x7F)
        self.bi = chr(int(pkt[14]) & 0x7F)
        self.more_to_come = int(pkt[len(pkt) - 4]) == 0x97
        parity = np.array([bin(int(b)).count("1") & 1 for b in pkt])
        if not parity[4:11].all():
            raise ValueError("Acars Text Parity Error")
        self.plane_reg = "".join(chr(int(b) & 0x7F) for b in pkt[4:11])
        self.has_text = int(pkt[15]) == 0x02
        self.message = ""
        if self.has_text:
            body = pkt[16: len(pkt) - 4]
            if not parity[16: len(pkt) - 4].all():
                raise ValueError("Acars Text Parity Error")
            self.message = "".join(
                "<DEL>" if (int(b) & 0x7F) == 0x7F else chr(int(b) & 0x7F)
                for b in body)

    def to_json(self) -> dict:
        return {"mode": self.mode, "tak": self.tak, "label": self.label,
                "bi": self.bi, "plane_reg": self.plane_reg,
                "more_to_come": self.more_to_come, "message": self.message}


class ACARSParser:
    """Multi-part reassembly keyed on plane_reg (acars_parser.cpp:69-98)."""

    def __init__(self):
        self._series: List[ACARSPacket] = []

    def parse(self, payload: np.ndarray) -> Optional[dict]:
        pkt = ACARSPacket(payload)
        if pkt.more_to_come:
            if self._series and self._series[0].plane_reg != pkt.plane_reg:
                self._series.clear()
            self._series.append(pkt)
            return None
        if self._series and self._series[0].plane_reg == pkt.plane_reg:
            msg = "".join(p.message for p in self._series) + pkt.message
            self._series.clear()
            out = pkt.to_json()
            out["message"] = msg
            return out
        return pkt.to_json()


def parse_isu_user_data(pkt: np.ndarray) -> dict:
    """MessageUserDataISU, packets_structs.h:77-106."""
    return {"message_type": int(pkt[0]),
            "aes_id": int(pkt[1]) << 16 | int(pkt[2]) << 8 | int(pkt[3]),
            "ges_id": int(pkt[4]), "q_no": int(pkt[5]) >> 4,
            "ref_no": int(pkt[5]) & 0xF, "seq_no": int(pkt[6]) & 0x3F,
            "no_of_bytes_in_last_su": int(pkt[7]) >> 4,
            "user_data": [int(b) for b in pkt[8:10]]}


def parse_system_table_index(pkt: np.ndarray) -> dict:
    """MessageAESSystemTableBroadcastIndex, packets_structs.h:35-74."""
    return {"message_type": int(pkt[0]), "revision_number": int(pkt[1]),
            "initial_seq_no_of_a2_31_partial": int(pkt[2]) >> 2,
            "initial_seq_no_of_a2_32_33_partial": int(pkt[3]) >> 2,
            "initial_seq_no_of_a2_34_partial": int(pkt[4]) >> 2,
            "initial_seq_no_of_a2_31_complete": int(pkt[5]) >> 2,
            "initial_seq_no_of_a2_32_33_complete": int(pkt[6]) >> 2,
            "initial_seq_no_of_a2_34_complete": int(pkt[7]) >> 2,
            "has_eirp_table_complete": bool((int(pkt[2]) >> 1) & 1),
            "has_eirp_table_partial": bool((int(pkt[3]) >> 1) & 1),
            "has_spot_beam_series": bool(int(pkt[9]) & 1)}


@register_module
class AeroParserModule(ProcessingModule):
    id = "inmarsat_aero_parser"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.is_c = bool(self.param("is_c", False))
        self.save_files = bool(self.param("save_files", True))
        self.station_id = str(self.param("station_id", ""))

    def _save(self, msg: dict, directory: str) -> None:
        self._npkts += 1
        if not self.save_files or "msg_name" not in msg:
            return
        name = msg["msg_name"].replace("/", "_")
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

    def _process_su(self, su: np.ndarray, directory: str, now: float) -> None:
        if not check_crc(su):
            logger.debug("Aero SU: invalid CRC")
            return
        pid = int(su[0])
        out: dict = {}
        if pid == 0x0A:
            out = parse_system_table_index(su)
        elif pid == 0x71:
            self._wip_isu = parse_isu_user_data(su)
            self._wip_ssu = []
            return
        elif pid == 0x26:
            return
        elif (pid & 0xC0) == 0xC0:
            if self._wip_isu is None:
                return
            ssu = {"seq_no": int(su[0]) & 0x3F,
                   "user_data": [int(b) for b in su[2:10]]}
            self._wip_ssu.append(ssu)
            if ssu["seq_no"] == 0:
                payload = list(self._wip_isu["user_data"])
                for s in self._wip_ssu[:-1]:
                    payload += s["user_data"]
                last = min(self._wip_isu["no_of_bytes_in_last_su"], 8)
                payload += self._wip_ssu[-1]["user_data"][:last]
                payload = np.array(payload, np.uint8)
                if is_acars_data(payload):
                    try:
                        ac = self._acars.parse(payload)
                    except ValueError as e:
                        logger.debug(f"ACARS: {e}")
                        ac = None
                    if ac is not None:
                        ac["msg_name"] = "ACARS"
                        ac["signal_unit"] = self._wip_isu
                        ac["timestamp"] = now
                        self._nacars += 1
                        logger.info(f"ACARS message ({ac['plane_reg']}) : "
                                    f"{ac['message']}")
                        self._save(ac, directory)
                self._wip_isu = None
            return
        name = pkt_type_to_name(pid)
        if "Reserved" not in name:
            out["msg_name"] = name
        out["timestamp"] = now
        self._save(out, directory)

    def process(self):
        directory = os.path.dirname(self.d_output_file_hint) or "."
        os.makedirs(directory, exist_ok=True)
        self.d_output_file = directory
        self._npkts = 0
        self._nacars = 0
        self._wip_isu = None
        self._wip_ssu: List[dict] = []
        self._acars = ACARSParser()
        now = float(self.param("start_timestamp", 0) or time.time())
        data = np.fromfile(self.d_input_file, np.uint8)
        if self.is_c:
            # frames of 3 SUs + 300 voice bytes (module_aero_parser.cpp)
            nfrm = len(data) // 336
            ambe = open(os.path.join(directory, "audio.ambe"), "wb")
            for i in range(nfrm):
                frm = data[i * 336: (i + 1) * 336]
                for k in range(3):
                    self._process_su(frm[k * SU_SIZE: (k + 1) * SU_SIZE],
                                     directory, now)
                ambe.write(frm[36:].tobytes())
            ambe.close()
        else:
            nfrm = len(data) // SU_SIZE
            for i in range(nfrm):
                self._process_su(data[i * SU_SIZE: (i + 1) * SU_SIZE],
                                 directory, now)
        self.stats = {"packets": self._npkts, "acars": self._nacars}
        logger.info(f"Aero parser: {self._npkts} packets, "
                    f"{self._nacars} ACARS")
