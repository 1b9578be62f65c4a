"""Inmarsat STD-C packet structures and field parsers.

Reference: plugins/inmarsat_support/stdc/packets_structs.h + pkt_structs.cpp —
every packet starts with a short/medium/long descriptor, ends with a 16-bit
Fletcher-style checksum, and carries the fields decoded below. Parsed packets
are plain dicts (the reference serializes the same fields to nlohmann::json).

Counterpart of satdump_tpu/pipeline/modules/inmarsat/stdc_pkts.py (host
NumPy, copied).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

ID_NAMES = {
    0x00: "Acknowledgement Request", 0x01: "Announcement",
    0x02: "Logical Channel Clear", 0x03: "Logical Channel Assignment",
    0x04: "LES TDM Channel Descriptor Packet", 0x05: "Network Monitor Packet",
    0x06: "Signalling Channel", 0x07: "Bulletin Board",
    0x10: "Acknowledgement", 0x11: "Distress Alert Acknowledgement",
    0x12: "Login Acknowledgement", 0x13: "Logout Acknowledgement",
    0x19: "LES Forced Clear", 0x1A: "Enhanced Data Report Acknowledgement",
    0x20: "Distress Test Request", 0x21: "Area Poll", 0x22: "Group Poll",
    0x23: "Individual Poll", 0x24: "Mobile To Base Station Poll",
    0x25: "Mobile To Mobile Poll", 0x28: "Confirmation",
    0x29: "Message Status", 0x2A: "Message Data", 0x2B: "Network Update",
    0x2C: "Request Status", 0x2D: "Test Result",
    0x30: "EGC Packet, single header", 0x31: "EGC double header, part 1",
    0x32: "EGC double header, part 2", 0x3D: "Multiframe Packet Start",
    0x3E: "Multiframe Packet Continue",
}

SAT_NAMES = {0: "Atlantic Ocean Region West (AOR-W)",
             1: "Atlantic Ocean Region East (AOR-E)",
             2: "Pacific Ocean Region (POR)",
             3: "Indian Ocean Region (IOR)",
             9: "All Ocean Regions Covered by the LES"}

# pkt_structs.cpp:98-205 (LES id + sat*100 -> operator)
_LES_GROUPS = [
    ((1, 101, 201, 301), "Vizada-Telenor, USA"),
    ((2, 102, 302), "Stratos Global (Burum-2), Netherlands"),
    ((202,), "Stratos Global (Aukland), New Zealand"),
    ((3, 103, 203, 303), "KDDI Japan"),
    ((4, 104, 204, 304), "Vizada-Telenor, Norway"),
    ((44, 144, 244, 344), "NCS"),
    ((105, 335), "Telecom, Italia"),
    ((305, 120), "OTESTAT, Greece"),
    ((306,), "VSNL, India"),
    ((110, 310), "Turk Telecom, Turkey"),
    ((211, 311), "Beijing MCN, China"),
    ((12, 112, 212, 312), "Stratos Global (Burum), Netherlands"),
    ((114,), "Embratel, Brazil"),
    ((116, 316), "Telekomunikacja Polska, Poland"),
    ((117, 217, 317), "Morsviazsputnik, Russia"),
    ((21, 121, 221, 321), "Vizada (FT), France"),
    ((127, 327), "Bezeq, Israel"),
    ((210, 328), "Singapore Telecom, Singapore"),
    ((330,), "VISHIPEL, Vietnam"),
]
_LES = {k: name for keys, name in _LES_GROUPS for k in keys}


def get_id_name(pid: int) -> str:
    return ID_NAMES.get(pid, "Unknown")


def get_sat_name(sat: int) -> str:
    return SAT_NAMES.get(sat, "Unknown")


def get_les_name(sat: int, les_id: int) -> str:
    value = les_id + sat * 100
    return f"{value}, {_LES.get(value, 'Unknown')}"


_SERVICE_BITS = ["MaritimeDistressAlerting", "SafetyNet", "InmarsatC",
                 "StoreFwd", "HalfDuplex", "FullDuplex", "ClosedNetwork",
                 "FleetNet", "PrefixSF", "LandMobileAlerting", "AeroC",
                 "ITA2", "DATA", "BasicX400", "EnhancedX400", "LowPowerCMES"]


def get_services_short(is8: int) -> dict:
    return {n: bool((is8 >> (7 - i)) & 1)
            for i, n in enumerate(_SERVICE_BITS[:8])}


def get_services(iss: int) -> dict:
    return {n: bool((iss >> (15 - i)) & 1)
            for i, n in enumerate(_SERVICE_BITS)}


def get_stations(data: np.ndarray, count: int) -> list:
    out = []
    j = 0
    for _ in range(count):
        if j + 6 > len(data):
            break
        sat = (int(data[j]) >> 6) & 3
        les = int(data[j]) & 0x3F
        st = {"sat_id": sat, "sat_name": get_sat_name(sat), "les_id": les,
              "les_name": get_les_name(sat, les),
              "services_start": int(data[j + 1])}
        st.update(get_services(int(data[j + 2]) << 8 | int(data[j + 3])))
        st["downlink_channel_mhz"] = ((int(data[j + 4]) << 8 | int(data[j + 4]))
                                      - 8000) * 0.0025 + 1530.5
        out.append(st)
        j += 6
    return out


# IA5 presentation: printable ASCII subset + CR/LF (pkt_structs.cpp:339-460)
def _ia5_char(b: int) -> str:
    b &= 0x7F
    if b in (10, 13) or (0x21 <= b <= 0x7D and b != 0x24):
        return chr(b)
    return " "


def string_from_ia5(buf: np.ndarray) -> str:
    return "".join(_ia5_char(int(b)) for b in buf)


def is_binary(data: np.ndarray, check_all: bool) -> bool:
    ctrl = {0x01, 0x05, 0x06, 0x07, 0x08, 0x0B, 0x0C, 0x0E, 0x0F, 0x10,
            0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x1A,
            0x1C, 0x1D, 0x1E, 0x1F, ord("$")}
    check = len(data) if check_all else min(13, len(data) - 2)
    return any((int(b) & 0x7F) in ctrl for b in data[:check])


def message_to_string(buf: np.ndarray, presentation: int, egc: bool) -> str:
    if presentation == 0:
        ret = string_from_ia5(buf)
    elif presentation == 7:
        ret = "".join(chr(int(b)) if int(b) < 128 else " " for b in buf)
    else:
        ret = ""
    if ret and not egc:
        ret = ret[:-1]
    return ret


def get_service_code_and_address_name(code: int) -> str:
    table = {
        0x00: "System, All ships (general call)",
        0x02: "FleetNET, Group Call",
        0x04: "SafetyNET, Navigational, Meteorological or Piracy Warning to"
              " a Rectangular Area",
        0x11: "System, Inmarsat System Message",
        0x13: "SafetyNET, Navigational, Meteorological or Piracy Coastal"
              " Warning",
        0x14: "SafetyNET, Shore-to-Ship Distress Alert to Circular Area",
        0x23: "System, EGC System Message",
        0x24: "SafetyNET, Navigational, Meteorological or Piracy Warning to"
              " a Circular Area",
        0x31: "SafetyNET, NAVAREA/METAREA Warning, MET Forecast or Piracy"
              " Warning to NAVAREA/METAREA",
        0x33: "System, Download Group Identity",
        0x34: "SafetyNET, SAR Coordination to a Rectangular Area",
        0x44: "SafetyNET, SAR Coordination to a Circular Area",
        0x72: "FleetNET, Chart Correction Service",
        0x73: "SafetyNET, Chart Correction Service for Fixed Areas",
    }
    return table.get(code, "Unknown")


def get_priority(priority: int) -> str:
    return {-1: "Message", 0: "Routine", 1: "Safety", 2: "Urgency",
            3: "Distress"}.get(priority, "Unknown")


def get_address_length(message_type: int) -> int:
    return {0x00: 3, 0x11: 4, 0x31: 4, 0x02: 5, 0x72: 5, 0x13: 6, 0x23: 6,
            0x33: 6, 0x73: 6, 0x04: 7, 0x14: 7, 0x24: 7, 0x34: 7,
            0x44: 7}.get(message_type, 3)


def parse_uplink_freq_mhz(b: np.ndarray) -> float:
    return ((int(b[0]) << 8 | int(b[1])) - 6000) * 0.0025 + 1626.5


def parse_downlink_freq_mhz(b: np.ndarray) -> float:
    return ((int(b[0]) << 8 | int(b[1])) - 8000) * 0.0025 + 1530.5


def service4_name(s: int) -> str:
    return {0: "Store And Forward", 1: "Half Duplex Data",
            2: "Circuit Switched Data (no ARQ)",
            3: "Circuit Switched Data (ARQ)",
            0xE: "Message Performance Verification"}.get(s, "Unknown")


def direction2_name(d: int) -> str:
    return {0: "To Mobile", 1: "From Mobile", 3: "Both"}.get(d, "Unknown")


# -- descriptor + checksum (packets_structs.h:42-127) -------------------------

def parse_descriptor(pkt: np.ndarray) -> dict:
    b0 = int(pkt[0])
    if b0 >> 7 == 0:        # short
        return {"is_short": True, "is_medium": False, "is_long": False,
                "type": (b0 >> 4) & 0b111, "length": (b0 & 0xF) + 1}
    if b0 >> 6 == 2:        # medium
        return {"is_short": False, "is_medium": True, "is_long": False,
                "type": b0 & 0x3F, "length": int(pkt[1]) + 2}
    return {"is_short": False, "is_medium": True, "is_long": False,
            "type": b0 & 0x3F,
            "length": (int(pkt[1]) << 8 | int(pkt[2])) + 3}


def compute_crc(buf: np.ndarray, size: int) -> int:
    c0 = c1 = 0
    for i in range(size):
        b = int(buf[i]) if i < size - 2 else 0
        c0 += b
        c1 += c0
    cb1 = (c0 - c1) & 0xFF
    cb2 = (c1 - 2 * c0) & 0xFF
    return cb1 << 8 | cb2


def append_crc(body: bytes) -> bytes:
    """TX-side helper: body with 2 zero CRC slots -> CRC filled."""
    buf = np.frombuffer(body, np.uint8)
    crc = compute_crc(buf, len(buf))
    return body[:-2] + bytes([crc >> 8, crc & 0xFF])


class PacketError(ValueError):
    pass


def _base(pkt: np.ndarray, len_max: int) -> dict:
    d = parse_descriptor(pkt)
    if d["length"] > len_max or d["length"] < 3:
        raise PacketError("Invalid PKT length!")
    sent = int(pkt[d["length"] - 2]) << 8 | int(pkt[d["length"] - 1])
    if sent != 0 and sent != compute_crc(pkt, d["length"]):
        raise PacketError("Invalid CRC!")
    return {"descriptor": d}


def _sat_les(out: dict, b: int) -> None:
    out["sat_id"] = (b >> 6) & 3
    out["les_id"] = b & 0x3F
    out["sat_name"] = get_sat_name(out["sat_id"])
    out["les_name"] = get_les_name(out["sat_id"], out["les_id"])


def parse_bulletin_board(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o.update(network_version=int(pkt[1]),
             frame_number=int(pkt[2]) << 8 | int(pkt[3]),
             signalling_channels=int(pkt[4]) >> 2,
             frame_2_count=((int(pkt[5]) >> 4) & 0xF) * 2,
             empty_frame=bool((int(pkt[5]) >> 3) & 1))
    o["seconds_of_day"] = o["frame_number"] * 8.64
    o["channel_type"] = int(pkt[6]) >> 5
    o["local_id"] = (int(pkt[6]) >> 2) & 7
    _sat_les(o, int(pkt[7]))
    o["status_b"] = int(pkt[8])
    o["services_b"] = int(pkt[9]) << 8 | int(pkt[10])
    o["randomizing_interval"] = int(pkt[11])
    o["channel_type_name"] = {1: "NCS", 2: "LES TDM",
                              3: "Joint NCS and TDM",
                              4: "ST-BY NCS"}.get(o["channel_type"],
                                                  "Reserved")
    sb = o["status_b"]
    o["status"] = {"return_link_speed": 600 if sb & 0x80 else 300,
                   "operational_sat": bool(sb & 0x40),
                   "in_service": bool(sb & 0x20), "clear": bool(sb & 0x10),
                   "links_open": bool(sb & 0x08),
                   "covert_alerting": bool(sb & 1)}
    o["services"] = get_services(o["services_b"])
    return o


def parse_signalling_channel(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["services_b"] = int(pkt[1])
    o["uplink_freq_mhz"] = parse_uplink_freq_mhz(pkt[2:])
    slots = []
    for j in range(7):
        b = int(pkt[4 + j])
        slots += [b >> 6, (b >> 4) & 3, (b >> 2) & 3, b & 3]
    o["tdm_slots"] = slots
    o["services"] = get_services_short(o["services_b"])
    return o


def parse_acknowledgement(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    _sat_les(o, int(pkt[2]))
    o.update(logical_channel_number=int(pkt[3]), frame_length=int(pkt[4]),
             duration=int(pkt[5]),
             message_channel=int(pkt[6]) << 8 | int(pkt[7]),
             frame_offset=int(pkt[8]), am_pm_bit=bool(int(pkt[9]) >> 7),
             slot_number=int(pkt[9]) & 0x1F)
    o["errored_packet_numbers"] = [int(pkt[9 + i]) for i in
                                   range(o["descriptor"]["length"] - 12)]
    return o


def parse_ack_request(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    _sat_les(o, int(pkt[1]))
    o.update(logical_channel_number=int(pkt[2]),
             uplink_freq_mhz=parse_uplink_freq_mhz(pkt[3:]),
             frame_offset=int(pkt[5]), am_pm_bit=bool(int(pkt[6]) >> 7),
             slot_number=int(pkt[6]) & 0x1F)
    return o


def parse_announcement(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["mes_id"] = int(pkt[2]) << 16 | int(pkt[3]) << 8 | int(pkt[4])
    _sat_les(o, int(pkt[5]))
    o["downlink_freq_mhz"] = parse_downlink_freq_mhz(pkt[6:])
    o["service_b"] = int(pkt[8]) >> 4
    o["direction_b"] = (int(pkt[8]) >> 2) & 3
    o["priority_b"] = int(pkt[8]) & 3
    if o["direction_b"] == 0:
        o.update(logical_channel_number=int(pkt[9]),
                 message_reference_number=(int(pkt[10]) << 16
                                           | int(pkt[11]) << 8
                                           | int(pkt[12])),
                 sub_address=int(pkt[13]), presentation=int(pkt[14]),
                 number_of_packets=int(pkt[15]), last_count=int(pkt[16]))
    o["service"] = service4_name(o["service_b"])
    o["direction"] = direction2_name(o["direction_b"])
    o["priority"] = {0: "Routine", 3: "Distress"}.get(o["priority_b"],
                                                      "Unknown")
    return o


def parse_les_forced_clear(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["mes_id"] = int(pkt[2]) << 16 | int(pkt[3]) << 8 | int(pkt[4])
    _sat_les(o, int(pkt[5]))
    o["logical_channel_number"] = int(pkt[6])
    o["reason_for_clear_b"] = int(pkt[7])
    reasons = {1: "LES Timeout", 2: "MES Procotol Error",
               3: "LES Hardware Error", 4: "Operator Forced Clear",
               5: "MES Forced Clear", 6: "LES Protocol Error",
               7: "MES Hardware Error", 8: "MES Timeout",
               9: "Unknown Presentation code",
               0xA: "Unable To Decode: Specified Dictionary Version Not"
                    " Available",
               0xB: "IWU Number Is Invalid",
               0xC: "MES Has Not Subscribed To This Service",
               0xD: "Requested Service Temporarily Unavailable",
               0xE: "Access To Requested Service Denied",
               0xF: "Invalid Service", 0x10: "Invalid Address",
               0x11: "Destination MES Not Commissioned",
               0x12: "Destination MES Not Logged In",
               0x13: "Destination MES Barred",
               0x14: "Requested Service Not Provided",
               0x15: "Protocol Version Not Supported",
               0x16: "Unrecognized PDU Type"}
    o["reason_for_clear"] = reasons.get(o["reason_for_clear_b"], "Unknown")
    return o


def parse_clear(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["mes_id"] = int(pkt[1]) << 16 | int(pkt[2]) << 8 | int(pkt[3])
    _sat_les(o, int(pkt[4]))
    o["logical_channel_number"] = int(pkt[5])
    return o


def _parse_status_tail(o: dict, pkt: np.ndarray) -> None:
    o["message_reference_number"] = (int(pkt[6]) << 16 | int(pkt[7]) << 8
                                     | int(pkt[8]))
    o["descriptor_length"] = int(pkt[9])
    o["status"] = bool(int(pkt[10]) >> 7)
    o["attempts_number"] = int(pkt[10]) & 0x7F
    o["non_delivery_code"] = string_from_ia5(pkt[11:14])
    o["address_information"] = string_from_ia5(
        pkt[14: 14 + max(o["descriptor_length"] - 5, 0)])


def parse_confirmation(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["mes_id"] = int(pkt[2]) << 16 | int(pkt[3]) << 8 | int(pkt[4])
    _sat_les(o, int(pkt[5]))
    _parse_status_tail(o, pkt)
    return o


def parse_message_status(pkt: np.ndarray, len_max: int) -> dict:
    return parse_confirmation(pkt, len_max)


def parse_mes_id_only(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["mes_id"] = int(pkt[2]) << 16 | int(pkt[3]) << 8 | int(pkt[4])
    if o["descriptor"]["length"] > 7:
        _sat_les(o, int(pkt[5]))
    return o


def parse_egc(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["service_code_b"] = int(pkt[2])
    o["continuation"] = bool(int(pkt[3]) >> 7)
    o["priority_b"] = (int(pkt[3]) >> 5) & 3
    o["repetition_number"] = int(pkt[3]) & 0x1F
    o["message_sequence_number"] = int(pkt[4]) << 8 | int(pkt[5])
    o["packet_sequence_number"] = int(pkt[6])
    o["presentation"] = int(pkt[7])
    o["service_code_and_address_name"] = \
        get_service_code_and_address_name(o["service_code_b"])
    o["priority"] = get_priority(o["priority_b"])
    alen = get_address_length(o["service_code_b"])
    length = o["descriptor"]["length"]
    if 8 + alen < length:
        o["address_raw"] = [int(b) for b in pkt[8: 8 + alen]]
        payload = pkt[8 + alen: length - 2]
        o["data"] = [int(b) for b in payload]
        o["message"] = message_to_string(payload, o["presentation"], True)
    else:
        o["message"] = ""
    return o


def parse_lca(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["mes_id"] = int(pkt[2]) << 16 | int(pkt[3]) << 8 | int(pkt[4])
    _sat_les(o, int(pkt[5]))
    o["service_b"] = int(pkt[6]) >> 4
    o["direction_b"] = (int(pkt[6]) >> 2) & 3
    if o["direction_b"] == 0:
        o.update(number_of_packets=int(pkt[7]), last_count=int(pkt[8]),
                 uplink_freq_mhz=parse_uplink_freq_mhz(pkt[9:]),
                 frame_offset=int(pkt[11]), am_pm_bit=bool(int(pkt[12]) >> 7),
                 slot_number=int(pkt[13]) & 0x1F)
    else:
        o.update(logical_channel_number=int(pkt[7]), frame_length=int(pkt[8]),
                 duration=int(pkt[9]),
                 downlink_freq_mhz=parse_downlink_freq_mhz(pkt[10:]),
                 message_channel=int(pkt[12]) << 8 | int(pkt[13]),
                 frame_offset=int(pkt[14]), am_pm_bit=bool(int(pkt[15]) >> 7),
                 slot_number=int(pkt[16]) & 0x1F)
    o["service"] = service4_name(o["service_b"])
    o["direction"] = direction2_name(o["direction_b"])
    return o


def parse_login_ack(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["mes_id"] = int(pkt[2]) << 16 | int(pkt[3]) << 8 | int(pkt[4])
    o["downlink_freq_mhz"] = parse_downlink_freq_mhz(pkt[5:])
    o["network_version"] = int(pkt[6])
    if o["descriptor"]["length"] > 7:
        o["les_total"] = int(pkt[8])
        o["stations"] = get_stations(pkt[9:], o["les_total"])
    return o


def parse_logout_ack(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["mes_id"] = int(pkt[2]) << 16 | int(pkt[3]) << 8 | int(pkt[4])
    return o


def parse_message_data(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    _sat_les(o, int(pkt[2]))
    o["logical_channel_number"] = int(pkt[3])
    o["packet_sequence_number"] = int(pkt[4])
    length = o["descriptor"]["length"]
    # the reference sizes data at length-6 but copies length-7 payload bytes,
    # leaving a trailing zero that message_to_string's drop-last-char eats
    # (packets_structs.h:838-844 + pkt_structs.cpp:495-497)
    data = np.append(pkt[5: length - 2], 0).astype(np.uint8)
    o["data"] = [int(b) for b in data]
    o["message"] = message_to_string(
        data, 7 if is_binary(data, True) else 0, False)
    return o


def parse_network_update(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["network_version"] = int(pkt[2])
    o["les_total"] = int(pkt[3])
    o["stations"] = get_stations(pkt[4:], o["les_total"])
    return o


def parse_request_status(pkt: np.ndarray, len_max: int) -> dict:
    o = _base(pkt, len_max)
    o["mes_id"] = int(pkt[2]) << 16 | int(pkt[3]) << 8 | int(pkt[4])
    _sat_les(o, int(pkt[5]))
    o["pending_reject_flag"] = bool(int(pkt[6]) >> 7)
    o["request_status_code"] = int(pkt[6]) & 0x7F
    return o


FRM_BULLETIN_BOARD = 0x07
FRM_SIGNALLING = 0x06
FRM_MESSAGE_DATA = 0x2A
FRM_EGC_SINGLE = 0x30
FRM_EGC_DOUBLE_1 = 0x31
FRM_EGC_DOUBLE_2 = 0x32
FRM_MULTI_START = 0x3D
FRM_MULTI_CONT = 0x3E

PARSERS = {
    0x00: parse_ack_request, 0x01: parse_announcement, 0x02: parse_clear,
    0x03: parse_lca, 0x06: parse_signalling_channel,
    0x07: parse_bulletin_board, 0x10: parse_acknowledgement,
    0x11: parse_mes_id_only, 0x12: parse_login_ack, 0x13: parse_logout_ack,
    0x19: parse_les_forced_clear, 0x20: parse_mes_id_only,
    0x28: parse_confirmation, 0x29: parse_message_status,
    0x2A: parse_message_data, 0x2B: parse_network_update,
    0x2C: parse_request_status, 0x2D: parse_mes_id_only,
    0x30: parse_egc, 0x31: parse_egc, 0x32: parse_egc,
}
