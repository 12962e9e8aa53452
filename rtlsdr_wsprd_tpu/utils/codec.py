"""WSPR message codec, decode side (host Python, bit-parity).

Re-implements the reference's message unpacking (wsprd/wsprd_utils.c):
``unpack50`` (:40-71), ``unpackcall`` (:73-118), ``unpackgrid`` (:120-150),
``unpackpfx`` (:152-194) and the type-1/2/3 dispatcher ``unpk_`` (:228-313).
String and bit manipulation is host work — it never touches the device — but
it defines the protocol, so behavior tracks the C reference exactly,
including its C-string quirks (space stripping, truncating snprintf
formats, fields left empty for type-2 messages).
"""

from __future__ import annotations

from dataclasses import dataclass

from .nhash import nhash

HASHTAB_SIZE = 32768  # wsprd/wsprd.h:36

_ALNUM = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ "  # index 36 is space


def unpack50(data: bytes | list[int]) -> tuple[int, int]:
    """Split the 50-bit payload of an 11-byte message into (n1, n2).

    n1 = first 28 bits (callsign field), n2 = next 22 bits (grid/power
    field). Mirrors wsprd/wsprd_utils.c:40-71.
    """
    d = [b & 255 for b in data[:7]]
    n1 = (d[0] << 20) + (d[1] << 12) + (d[2] << 4) + ((d[3] >> 4) & 15)
    n2 = ((d[3] & 15) << 18) + (d[4] << 10) + (d[5] << 2) + ((d[6] >> 6) & 3)
    return n1, n2


def unpackcall(ncall: int) -> str | None:
    """Decode a 28-bit callsign field to a string (wsprd/wsprd_utils.c:73-118).

    Returns None when ncall is out of range (the C returns 0 and leaves
    the buffer as "......").
    """
    n = ncall
    if n >= 262177560 or n < 0:
        return None
    tmp = [""] * 6
    tmp[5] = _ALNUM[n % 27 + 10]; n //= 27
    tmp[4] = _ALNUM[n % 27 + 10]; n //= 27
    tmp[3] = _ALNUM[n % 27 + 10]; n //= 27
    tmp[2] = _ALNUM[n % 10]; n //= 10
    tmp[1] = _ALNUM[n % 36]; n //= 36
    tmp[0] = _ALNUM[n]
    # The C strips leading spaces then NUL-terminates at trailing spaces
    # (wsprd/wsprd_utils.c:102-113).
    s = "".join(tmp)
    i = 0
    while i < 5 and s[i] == " ":
        i += 1
    s = s[i:]
    j = s.find(" ")
    return s[:j] if j >= 0 else s


def unpackgrid(ngrid: int) -> str | None:
    """Decode the grid field to a 4-char Maidenhead locator.

    Mirrors wsprd/wsprd_utils.c:120-150; returns None (C: "XXXX"/0) when
    out of range.
    """
    g = ngrid >> 7
    if g >= 32400 or g < 0:
        return None
    dlat = (g % 180) - 90
    dlong = (g // 180) * 2 - 180 + 2
    if dlong < -180:
        dlong += 360
    if dlong > 180:
        dlong += 360
    nlong = int(60.0 * (180.0 - dlong) / 5.0)
    n1 = nlong // 240
    n2 = (nlong - 240 * n1) // 24
    c0, c2 = _ALNUM[10 + n1], _ALNUM[n2]
    nlat = int(60.0 * (dlat + 90) / 2.5)
    n1 = nlat // 240
    n2 = (nlat - 240 * n1) // 24
    c1, c3 = _ALNUM[10 + n1], _ALNUM[n2]
    return c0 + c1 + c2 + c3


def unpackpfx(nprefix: int, call: str) -> str | None:
    """Attach a prefix or suffix to ``call`` (wsprd/wsprd_utils.c:152-194)."""
    if nprefix < 60000:
        # 1-3 character prefix
        n = nprefix
        pfx = [" "] * 3
        for i in (2, 1, 0):
            nc = n % 37
            if 0 <= nc <= 9:
                pfx[i] = chr(nc + 48)
            elif 10 <= nc <= 35:
                pfx[i] = chr(nc + 55)
            else:
                pfx[i] = " "
            n //= 37
        # C: strrchr(pfx, ' ') → keep the part after the LAST space
        s = "".join(pfx)
        last_space = s.rfind(" ")
        head = s[last_space + 1 :] if last_space >= 0 else s
        return f"{head}/{call}"[:12]
    nc = nprefix - 60000
    if 0 <= nc <= 9:
        return f"{call}/{chr(nc + 48)}"[:12]
    if 10 <= nc <= 35:
        return f"{call}/{chr(nc + 55)}"[:12]
    if 36 <= nc <= 125:
        c0 = chr((nc - 26) // 10 + 48)
        c1 = chr((nc - 26) % 10 + 48)
        return f"{call}/{c0}{c1}"[:12]
    return None


@dataclass
class UnpackedMessage:
    """Result of unpacking one decoded 50-bit WSPR message."""

    call_loc_pow: str  # full message string, e.g. "K1JT FN20 20"
    call: str          # callsign ("" for type-2, matching the reference)
    loc: str           # locator ("" for type-2)
    pwr: str           # power in dBm ("" for type-2)
    callsign: str      # dedupe key (always set on success)
    noprint: bool      # message failed a sanity check (still reported)
    ihash: int = -1    # type-3 only: the 15-bit callsign hash looked
    #                    up (resolved or not); -1 for type 1/2. Lets a
    #                    pipelined consumer re-resolve a "<...>" spot
    #                    once its teacher batch has completed
    #                    (parallel/multichannel.resolve_type3_spots).


def unpack_message(message: bytes | list[int], hashtable) -> UnpackedMessage | None:
    """Unpack an 11-byte decoded message (wsprd/wsprd_utils.c:228-313).

    ``hashtable`` is a mutable mapping with ``put(ihash, call, grid)`` and
    ``get_call(ihash) -> str | None`` (see utils.hashtable). Returns None
    on hard failure (the C returns 1 with no fields set).

    Divergence from the reference: C's type-2 power snprintf uses "%2d"
    into a 3-byte buffer, identical here via zfill/rjust emulation.
    """
    n1, n2 = unpack50(message)
    callsign = unpackcall(n1)
    if callsign is None:
        return None
    grid = unpackgrid(n2)
    if grid is None:
        return None
    ntype = (n2 & 127) - 64

    if 0 <= ntype <= 62:
        nu = ntype % 10
        if nu in (0, 3, 7):
            # Type 1: call grid power
            cdbm = f"{ntype:02d}"
            ihash = nhash(callsign)
            hashtable.put(ihash, callsign, grid)
            return UnpackedMessage(
                call_loc_pow=f"{callsign} {grid} {cdbm}"[:22],
                call=callsign[:12], loc=grid[:6], pwr=cdbm[:2],
                callsign=callsign[:12], noprint=False,
            )
        # Type 2: extended callsign + power
        nadd = nu
        if nu > 3:
            nadd = nu - 3
        if nu > 7:
            nadd = nu - 7
        n3 = n2 // 128 + HASHTAB_SIZE * (nadd - 1)
        pfx_call = unpackpfx(n3, callsign)
        if pfx_call is None:
            return None
        ndbm = ntype - nadd
        cdbm = f"{ndbm:2d}"
        noprint = False
        if ndbm % 10 in (0, 3, 7):
            hashtable.put(nhash(pfx_call), pfx_call, None)
        else:
            noprint = True
        # The reference leaves call/loc/pwr empty for type 2
        # (wsprd/wsprd_utils.c:264-279 never writes them).
        return UnpackedMessage(
            call_loc_pow=f"{pfx_call} {cdbm}"[:22],
            call="", loc="", pwr="",
            callsign=pfx_call[:12], noprint=noprint,
        )

    if ntype < 0:
        # Type 3: hashed callsign + 6-char grid + power
        ndbm = -(ntype + 1)
        # grid6 = last char of the pseudo-callsign + its first 5 chars
        # (wsprd/wsprd_utils.c:282-284). The pseudo-call may be shorter
        # than 6 chars; C-string semantics truncate at the first NUL.
        ch = callsign[5] if len(callsign) > 5 else "\0"
        grid6 = (ch + callsign[:5]).split("\0")[0]
        nu = ndbm % 10
        noprint = False
        if (
            nu not in (0, 3, 7)
            or len(grid6) < 4
            or not grid6[0].isalpha() or not grid6[1].isalpha()
            or not grid6[2].isdigit() or not grid6[3].isdigit()
        ):
            noprint = True
        ihash = (n2 - ntype - 64) // 128
        stored = hashtable.get_call(ihash)
        hashed_call = f"<{stored}>" if stored else "<...>"
        hashed_call = hashed_call[:12]
        cdbm = f"{ndbm:2d}"
        if ntype == -64:  # "A000AA" grids (wsprd/wsprd_utils.c:309-310)
            noprint = True
        return UnpackedMessage(
            call_loc_pow=f"{hashed_call} {grid6} {cdbm}"[:22],
            call=hashed_call[:12], loc=grid6[:6], pwr=cdbm[:2],
            callsign=hashed_call[:12], noprint=noprint, ihash=ihash,
        )

    return None
