"""Crowded-band study: ours vs the reference oracle on dense windows.

The C subtracts each decode immediately, affecting later candidates in
the SAME pass (wsprd/wsprd.c:781-789); this rebuild batches subtraction
per pass (models/decoder.py docstring documents the divergence). This
tool bounds the effect: decode N random MULTI-SIGNAL windows (4..12
overlapping transmissions each) through both decoders and report
message-level precision/recall against ground truth, plus cross-decoder
agreement.

Round 5 addition (VERDICT r4 next-step 2): the same windows are also
decoded with MORE passes than the reference can afford — its
``ipass==2`` branch (maxdrift=0, minsync2 relaxed to 0.10,
wsprd/wsprd.c:521-531) ships DEAD because npasses is hard-coded to 2;
our pass loop implements it (multichannel.py pass loop), so a third
pass costs only device time. Each configured pass
count decodes the SAME windows, so the deltas are paired.

Usage: python tools/crowded_band.py [n_windows] [max_signals] [cfg,cfg,...]
where each cfg is ``NPASSES`` or ``NPASSES@MAXCYCLES`` (the Fano
budget axis — e.g. ``2,2@100000`` pairs the production 10k budget
against a 10x budget on the SAME windows). Prints a summary table and
one JSON line per config.
"""

from __future__ import annotations

import json
import string
import sys
import tempfile

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

from rtlsdr_wsprd_tpu.config import DecoderOptions  # noqa: E402
from rtlsdr_wsprd_tpu.parallel.multichannel import decode_channels  # noqa: E402
from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db  # noqa: E402
from rtlsdr_wsprd_tpu.runtime.synth import synth_window_at_snr  # noqa: E402
from rtlsdr_wsprd_tpu.utils.channel import get_wspr_channel_symbols  # noqa: E402
from rtlsdr_wsprd_tpu.utils.hashtable import WsprHashTable  # noqa: E402

PWRS = [0, 3, 7, 10, 13, 17, 20, 23, 27, 30, 33, 37]


def random_message(rng: np.random.Generator, ht: WsprHashTable) -> str:
    """A random encodable type-1 message (call grid4 power)."""
    up = string.ascii_uppercase
    while True:
        call = (rng.choice(list(up)) + str(rng.integers(0, 10))
                + "".join(rng.choice(list(up))
                          for _ in range(int(rng.integers(1, 4)))))
        grid = (up[rng.integers(0, 18)] + up[rng.integers(0, 18)]
                + str(rng.integers(0, 10)) + str(rng.integers(0, 10)))
        msg = f"{call} {grid} {int(rng.choice(PWRS))}"
        if get_wspr_channel_symbols(msg, ht) is not None:
            return msg


def main() -> None:
    n_windows = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    max_sig = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    # config tokens: "NP" or "NP@MAXCYCLES" (e.g. "2,2@100000" pairs the
    # production budget against a 10x Fano budget on the SAME windows —
    # the budget axis the round-5 gate/pass sweeps never exercised)
    configs = ([(int(t.partition("@")[0]),
                 int(t.partition("@")[2]) if "@" in t else 10000)
                for t in sys.argv[3].split(",")]
               if len(sys.argv) > 3 else [(2, 10000), (3, 10000)])

    import oracle
    have_oracle = oracle.available()
    workdir = tempfile.mkdtemp(prefix="crowded_")

    rng = np.random.default_rng(424242)
    ht = WsprHashTable()
    B = n_windows
    wi = np.zeros((B, 45000), np.float32)
    wq = np.zeros((B, 45000), np.float32)
    truth: list[set[str]] = []
    for b in range(B):
        k = int(rng.integers(4, max_sig + 1))
        msgs, f0s, snrs, t0s = [], [], [], []
        used_f: list[float] = []
        for _ in range(k):
            # keep >= 3 Hz spacing so ground truth is unambiguous
            # (the decoder dedupes same-call within 3 Hz)
            for _ in range(50):
                f = float(rng.uniform(-105, 105))
                if all(abs(f - u) > 4.0 for u in used_f):
                    break
            used_f.append(f)
            msgs.append(random_message(rng, ht))
            f0s.append(f)
            snrs.append(float(rng.uniform(-25.0, -3.0)))
            t0s.append(float(rng.uniform(0.0, 4.0)))
        i, q = synth_window_at_snr(msgs, snr_db=snrs, f0=f0s, t0=t0s,
                                   seed=int(rng.integers(1 << 30)))
        wi[b], wq[b] = normalize_minus3db(i, q)
        truth.append(set(msgs))

    ours_by_cfg: dict[tuple[int, int], list[set[str]]] = {}
    for np_, mc in configs:
        options = DecoderOptions(npasses=np_, maxcycles=mc)
        spots = decode_channels(wi, wq, options, device_batch=32)
        ours_by_cfg[(np_, mc)] = [set(s.message for s in ch)
                                  for ch in spots]
    ours = ours_by_cfg[configs[0]]

    refs: list[set[str]] = []
    if have_oracle:
        for b in range(B):
            rs = oracle.wspr_decode_reference(
                wi[b], wq[b], dialfreq=14095600, workdir=workdir)
            refs.append(set(s.message for s in rs))
            if (b + 1) % 20 == 0:
                print(f"  oracle {b + 1}/{B}", file=sys.stderr, flush=True)

    def prf(decoded: list[set[str]]):
        tp = sum(len(d & t) for d, t in zip(decoded, truth))
        fp = sum(len(d - t) for d, t in zip(decoded, truth))
        fn = sum(len(t - d) for d, t in zip(decoded, truth))
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        return tp, fp, fn, prec, rec

    total_true = sum(len(t) for t in truth)
    print(f"windows={B} true-messages={total_true} "
          f"signals/window<={max_sig}")
    ref_stats = None
    if have_oracle:
        r_tp, r_fp, r_fn, r_p, r_r = prf(refs)
        print(f"ref : tp={r_tp} fp={r_fp} fn={r_fn} "
              f"precision={r_p:.3f} recall={r_r:.3f}")
        ref_stats = (r_p, r_r)
    for np_, mc in configs:
        ours = ours_by_cfg[(np_, mc)]
        o_tp, o_fp, o_fn, o_p, o_r = prf(ours)
        print(f"ours(npasses={np_}, maxcycles={mc}): tp={o_tp} "
              f"fp={o_fp} fn={o_fn} "
              f"precision={o_p:.3f} recall={o_r:.3f}")
        out = {"windows": B, "true_messages": total_true,
               "npasses": np_, "maxcycles": mc,
               "ours_precision": round(o_p, 4),
               "ours_recall": round(o_r, 4)}
        if have_oracle:
            both = sum(len(o & r) for o, r in zip(ours, refs))
            only_ours = sum(len((o - r) & t)
                            for o, r, t in zip(ours, refs, truth))
            only_ref = sum(len((r - o) & t)
                           for o, r, t in zip(ours, refs, truth))
            print(f"  agreement: both={both} true-only-ours={only_ours} "
                  f"true-only-ref={only_ref}")
            out.update({"ref_precision": round(ref_stats[0], 4),
                        "ref_recall": round(ref_stats[1], 4),
                        "true_only_ours": only_ours,
                        "true_only_ref": only_ref})
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
