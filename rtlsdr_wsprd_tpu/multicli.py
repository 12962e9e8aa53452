"""Many-channel daemon CLI: the terminal surface of the integrated
ingest->spots chain (runtime/multidaemon.MultiChannelDaemon).

The reference daemon serves exactly one dongle per process
(rtlsdr_wsprd.c:961-1203); this entry point drives a BANK of channels
— one rtl_tcp server per dongle/band, or synthetic channels for load
generation — through one batched device pipeline.

    python -m rtlsdr_wsprd_tpu.multicli \
        --endpoint sdr0:1234:20m --endpoint sdr1:1234:40m \
        -c A1XYZ -l AB12cd

    python -m rtlsdr_wsprd_tpu.multicli --synth 8 -n 1 -x

Frequency accepts the same band names / unit suffixes as the main CLI
(-f). Reporting posts each channel's spots with that channel's dial
frequency.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__, compile_cache
from .cli import parse_frequency
from .config import DecoderOptions
from .runtime.banks import RtlTcpBank, SyntheticRawBank
from .runtime.multidaemon import MultiChannelDaemon
from .runtime.reporting import WsprnetReporter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rtlsdr_wsprd_tpu.multicli",
        description="JAX many-channel WSPR daemon",
        add_help=False,
    )
    p.add_argument("--endpoint", action="append", default=[],
                   metavar="HOST:PORT:FREQ|BAND",
                   help="rtl_tcp server + dial frequency; repeat per "
                        "channel")
    p.add_argument("--synth", type=int, default=0, metavar="N",
                   help="N synthetic channels instead of rtl_tcp "
                        "(self-test / load generation)")
    p.add_argument("-c", dest="rcall", default="", metavar="CALLSIGN")
    p.add_argument("-l", dest="rloc", default="", metavar="LOCATOR")
    p.add_argument("-g", dest="gain", type=int, default=29,
                   help="gain [0-49] for every dongle (default 29)")
    p.add_argument("-a", dest="autogain", action="store_true")
    p.add_argument("-p", dest="ppm", type=int, default=0)
    p.add_argument("-n", dest="maxloop", type=int, default=0,
                   help="stop after N window batches (0 = infinite)")
    p.add_argument("-H", dest="usehashtable", action="store_true")
    p.add_argument("-Q", dest="quickmode", action="store_true")
    p.add_argument("-S", dest="singlepass", action="store_true")
    p.add_argument("-x", dest="noreport", action="store_true")
    p.add_argument("--device-batch", type=int, default=64,
                   help="windows per device decode batch (default 64)")
    p.add_argument("--dial", action="append", default=[],
                   metavar="FREQ|BAND", dest="dials",
                   help="wideband: decode this ADDITIONAL dial from the "
                        "single --endpoint capture (repeatable; the "
                        "2.4 Msps span covers endpoint dial -593.5 kHz "
                        "to +1796.5 kHz)")
    p.add_argument("--reconnect", action="store_true",
                   help="ride out rtl_tcp server restarts: redial + "
                        "re-tune instead of ending the stream")
    p.add_argument("--no-align", dest="noalign", action="store_true",
                   help="skip the 2-minute wall-clock capture alignment "
                        "(replay/faster-than-realtime rtl_tcp servers)")
    p.add_argument("--frontend", choices=("auto", "device", "host"),
                   default="auto",
                   help="where the 6400:1 decimator runs: device (raw "
                        "uint8 to the chip), host (native C++; only "
                        "375 sps baseband crosses the link); auto is "
                        "device")
    p.add_argument("-w", dest="writefile", metavar="PREFIX", default=None,
                   help="save each channel's normalized window as "
                        "PREFIX_chNN_<timestamp>.iq (reference -w)")
    p.add_argument("--fec", choices=("auto", "host", "hybrid"),
                   default="auto",
                   help="FEC strategy: auto = per-backend calibration "
                        "(ops/calibrate.py; RTLSDR_WSPRD_TPU_FEC also "
                        "pins it), host = native sequential decoder, "
                        "hybrid = batched device search + native "
                        "straggler finish")
    p.add_argument("--devices", choices=("default", "all"),
                   default="default",
                   help="decode on the default device, or shard each "
                        "window batch's channels across ALL local "
                        "chips (one staged pipeline per chip)")
    p.add_argument("--strict-hash-order", action="store_true",
                   help="with -H: compatibility mode serializing window "
                        "batches (disables the pipeline overlap). Type-3 "
                        "<hash> spots already resolve race-free at yield "
                        "time by default; this additionally matches the "
                        "reference's decode-time side effects (dedupe "
                        "key / subtraction of a then-unresolved type-3)")
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="multi-host mode: jax.distributed coordinator "
                        "address (rank 0's host); every rank runs this "
                        "same command with its own --rank")
    p.add_argument("--nprocs", type=int, default=1, metavar="N",
                   help="multi-host mode: total process count (the "
                        "global channel set splits contiguously across "
                        "ranks; each rank ingests, decodes and reports "
                        "only its own slice)")
    p.add_argument("--rank", type=int, default=0, metavar="K",
                   help="multi-host mode: this process's rank [0, N)")
    p.add_argument("--help", action="help")
    p.add_argument("--version", action="version",
                   version=f"rtlsdr_wsprd_tpu {__version__}")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    compile_cache.enable()

    if bool(args.endpoint) == bool(args.synth):
        print("Specify either --endpoint (one per channel) or "
              "--synth N.\n --help for usage...", file=sys.stderr)
        return 1
    if not args.noreport and (not args.rcall or not args.rloc):
        print("Please specify your callsign and locator (or -x).\n"
              " --help for usage...", file=sys.stderr)
        return 1

    # multi-host mode: wire every rank into ONE jax runtime (pod slice
    # or CPU cluster) before anything touches the backend, then keep
    # only this rank's contiguous slice of the GLOBAL channel set —
    # each rank ingests, decodes (on its local chips) and reports its
    # own channels; sample data never crosses hosts (SURVEY.md
    # section 5: decode is embarrassingly parallel per window). The
    # reference's whole live path serves one dongle in one process
    # (rtlsdr_wsprd.c:126-328); this scales that chain to N hosts.
    distributed = args.coordinator is not None or args.nprocs > 1
    sl = slice(None)
    if distributed:
        if args.coordinator is None or not 0 <= args.rank < args.nprocs:
            print("Multi-host mode needs --coordinator HOST:PORT and "
                  "0 <= --rank < --nprocs.", file=sys.stderr)
            return 1
        if args.dials:
            print("--dial (wideband) decodes ONE dongle's capture; it "
                  "cannot split across ranks.", file=sys.stderr)
            return 1
        from .parallel import distributed as dist

        dist.initialize(coordinator=args.coordinator,
                        num_processes=args.nprocs, process_id=args.rank)
        sl = dist.rank_slice(
            args.synth if args.synth else len(args.endpoint),
            args.rank, args.nprocs)
        if sl.start >= sl.stop:
            print(f"Rank {args.rank}: no channels to serve (more ranks "
                  "than channels).", file=sys.stderr)
            return 1
        import jax

        print(f"Distributed: rank {args.rank}/{args.nprocs} serving "
              f"channels [{sl.start}, {sl.stop}) on "
              f"{len(jax.local_devices())} local device(s), "
              f"{len(jax.devices())} global.")

    dialfreqs: list[int] = []
    if args.synth:
        f0s = [(37 * k) % 180 - 90.0 for k in range(args.synth)][sl]
        seeds = list(range(1000, 1000 + args.synth))[sl]
        bank = SyntheticRawBank(len(f0s), f0s=f0s, seeds=seeds)
        dialfreqs = [14_095_600] * len(f0s)
    else:
        endpoints = []
        for ep in args.endpoint:
            try:
                host, port, freq = ep.rsplit(":", 2)
            except ValueError:
                print(f"Bad --endpoint {ep!r} (HOST:PORT:FREQ)",
                      file=sys.stderr)
                return 1
            dialfreq, directsampling = parse_frequency(freq)
            dialfreqs.append(dialfreq)
            if dialfreq == 0:
                print(f"Bad frequency in --endpoint {ep!r}",
                      file=sys.stderr)
                return 1
            endpoints.append((host, int(port), dialfreq, dict(
                gain_tenths_db=max(0, min(49, args.gain)) * 10,
                autogain=args.autogain, ppm=args.ppm,
                directsampling=directsampling,
                reconnect=args.reconnect)))
        # every rank validates the FULL endpoint list (identical
        # command line everywhere), then connects only to its own
        endpoints = endpoints[sl]
        dialfreqs = dialfreqs[sl]
        bank = RtlTcpBank(endpoints)

    channelize = None
    if args.dials:
        if args.synth or len(args.endpoint) != 1:
            print("--dial (wideband) needs exactly one --endpoint.",
                  file=sys.stderr)
            return 1
        channelize = [dialfreqs[0]]
        for d in args.dials:
            f, _ds = parse_frequency(d)
            # the tuned center is dial0 + 601.5 kHz (fs/4 offset), so
            # the 2.4 Msps capture covers dial0 - 598.5k .. + 1801.5k;
            # 5 kHz margin keeps the band off the Nyquist edges
            if f == 0 or not (-593_500 < f - dialfreqs[0] < 1_796_500):
                print(f"Bad --dial {d!r} (unknown or outside the "
                      "2.4 Msps span: dial-593.5k .. dial+1796.5k)",
                      file=sys.stderr)
                return 1
            channelize.append(f)
        dialfreqs = list(channelize)

    options = DecoderOptions(
        freq=dialfreqs[0],
        rcall=args.rcall[:12].upper(),
        rloc=args.rloc[:6],
        quickmode=args.quickmode,
        usehashtable=args.usehashtable,
        npasses=1 if args.singlepass else 2,
        subtraction=not args.singlepass,
    )
    reporters = None
    if not args.noreport:
        # background delivery: a slow wsprnet never stalls the decode
        # pipeline (join-on-shutdown in the finally below)
        reporters = [WsprnetReporter(options.rcall, options.rloc, df,
                                     background=True)
                     for df in dialfreqs]

    daemon = MultiChannelDaemon(
        bank, options, quiet=False,
        device_batch=args.device_batch,
        fec=args.fec, dialfreqs=dialfreqs, reporters=reporters,
        align=not args.synth and not args.noalign,
        frontend=args.frontend, channelize=channelize,
        devices=args.devices, strict_hash_order=args.strict_hash_order,
        write_prefix=args.writefile)
    print(f"FEC strategy : {daemon.describe_fec()}")
    print(f"Front end    : {daemon.frontend_placement}")
    try:
        daemon.run(max_windows=args.maxloop)
    finally:
        bank.close()
        if reporters is not None:
            for r in reporters:
                r.close()  # join worker + final delivery attempt
            # include anything dropped during the shutdown drain
            daemon.stats.dropped_reports = sum(r.dropped
                                               for r in reporters)
    s = daemon.stats
    tag = f"[rank {args.rank}] " if distributed else ""
    print(f"{tag}Processed {s.window_batches} window batch(es), "
          f"{s.channel_windows} channel-windows, {s.spots} spot(s), "
          f"{s.errors} error(s).")
    if s.dropped_reports:
        print(f"WARNING: {s.dropped_reports} report(s) dropped "
              "(wsprnet unreachable past the retry horizon)",
              file=sys.stderr)
    dropped = getattr(bank, "dropped_bytes", None)
    if dropped and any(dropped):
        # the RX ring overflowed: the host fell behind the stream and
        # whole chunks were discarded (the dongle-overflow analog) —
        # windows spanning the gaps will not decode
        print("WARNING: ingest ring overflow, dropped bytes per "
              f"channel: {dropped}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
