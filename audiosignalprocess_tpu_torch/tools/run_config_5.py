"""Config 5: the streaming 128-channel chain, 44.1 -> 48 kHz at 160/147,
then a 64-tap FIR, the STFT noise gate (1024/256, 8 noise frames) and the
envelope (129 taps), block-streamed with exact carries, or time-sharded
over the ranks as one whole-file program.

    python -m audiosignalprocess_tpu_torch.tools.run_config_5 --check [--device cpu]
    python -m audiosignalprocess_tpu_torch.tools.run_config_5 --mode ring --check \\
        --demo-restart [--ring-batch K] [--drain]
    torchrun --standalone --nproc-per-node=4 -m audiosignalprocess_tpu_torch.tools.run_config_5 \\
        --mode sharded --check [--backend gloo]

Modes:

- ``stream``: ``Chain.stream`` over blocks of 147 x 64 input samples.
  With the kernels (the default) each block launches ``resample_mac``,
  ``overlap_save_fused``, ``gate_step_fused`` and ``fir_mac``;
  ``--composite`` runs the chain as one ``ResFIRGateStage``, one
  ``res_fir_gate_step_fused`` a block, the envelope folded in.  With
  ``--no-fused`` either chain takes its unfused route: the plain
  resampler and envelope (no launch), and the FIR's and the gate's FFTs
  on ``ops.fft``'s default impl (two ``rfft_stockham`` and two
  ``irfft_stockham`` a block on the card).
- ``ring``: a native decode thread (``io.wav_native.WavReader``) feeds a
  single-producer/single-consumer ring while the main thread pops blocks,
  uploads them from pinned memory and steps the chain on the device
  (``run_ring``); ``--ring-batch K`` pops and uploads K blocks at once,
  ``--demo-restart`` checkpoints at the middle block, restarts from the
  checkpoint and checks the tail bit for bit, ``--drain`` streams the
  whole file.
- ``sharded``: ``parallel.sharded_chain`` on a (1, ranks) mesh (time
  shards of whole multiples of 147 x 32 samples): ``resample_mac``,
  ``overlap_save_fused``, ``gate_shard_fused`` and ``fir_mac`` on each
  rank.

``--check``: ``ring`` against ``Chain.stream`` of the same samples on the
same device (bit-equal, or >= 100 dB; with ``--drain`` also the same
length as ``stream(drain=True)``); ``stream`` and ``sharded`` against the
float64 plain ``Chain.full`` on the CPU, on two channels (>= 60 dB).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

import numpy as np
import torch

from audiosignalprocess_tpu_torch.io import wav_native
from audiosignalprocess_tpu_torch.io.wav import write_wav
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.parallel import (
    initialize, make_mesh, shard_audio, sharded_chain,
)
from audiosignalprocess_tpu_torch.pipeline import (
    Chain, EnvelopeStage, FIRStage, GateStage, ResampleStage, ResFIRGateStage,
)
from audiosignalprocess_tpu_torch.tools.common import (
    load_or_make, maybe_write, report, snr_db, std_parser, timed, to_host, world,
)
from audiosignalprocess_tpu_torch.utils.checkpoint import load_carry, save_carry
from audiosignalprocess_tpu_torch.utils.profiling import BlockLogger
from audiosignalprocess_tpu_torch.utils.validate import check

RATE_IN, RATE_OUT = 44100, 48000
CHANNELS = 128
BLOCK = 147 * 64  # input block: a multiple of down=147 and of the composite's 1176
SHARD_QUANTUM = 147 * 32  # a time shard is a whole multiple of this
SPIN_S = 0.0002  # producer and consumer poll the ring this often


def build_chain(fused: bool = True, composite: bool = False) -> Chain:
    """The config-5 chain: four stages, or with ``composite`` one
    ``ResFIRGateStage``; ``fused=False`` takes the unfused route of
    either."""
    if composite:
        return Chain([ResFIRGateStage(
            up=160, down=147, h=design_fir(64, 0.3), nfft=1024, hop=256, noise_frames=8,
            env_h=design_fir(129, 0.01), fused=fused)])
    return Chain([
        ResampleStage(up=160, down=147, fused=fused),
        FIRStage(h=design_fir(64, 0.3), nfft=1024, fused=fused),
        GateStage(nfft=1024, hop=256, noise_frames=8, fused=fused),
        EnvelopeStage(design_fir(129, 0.01), fused=fused),
    ])


def _upload(ring: wav_native.RingBuffer, frames: int, dev: torch.device) -> torch.Tensor:
    """Pop ``frames`` frames as one (channels, frames) tensor on ``dev``.

    To the card: popped straight into a pinned buffer of the caching host
    allocator and copied without blocking; the allocator keeps the buffer
    from reuse until the copy has run, so a later pop never overwrites a
    block still in flight."""
    if dev.type != "cuda":
        return torch.from_numpy(ring.pop(frames)[0])
    host = torch.empty((ring.channels, frames), dtype=torch.float32, pin_memory=True)
    ring.pop(frames, out=host.numpy())
    return host.to(dev, non_blocking=True)


def _download(y: torch.Tensor) -> torch.Tensor:
    """Start ``y``'s copy to the host without waiting (pinned memory from
    the card), so the stream never waits for the device and the outputs
    do not pile up in device memory."""
    if not y.is_cuda:
        return y
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    return host.copy_(y, non_blocking=True)


def run_ring(chain: Chain, wav_path: str, block: int, channels: int, nblocks: int | None = None,
             resume: str | None = None, ckpt: tuple | None = None, logger=None,
             batch_blocks: int = 1, warmup: bool = False, drain: bool = False,
             device: str | torch.device = "cuda", stats: dict | None = None):
    """Ring-buffer streaming of the float32 file ``wav_path``: a native
    decode thread feeds the SPSC ring while this thread pops blocks and
    runs ``chain.step`` on ``device``, so host decode overlaps device
    compute.  Returns (output as numpy, blocks processed, seconds).

    ``resume`` restarts from a saved carry checkpoint (``utils.checkpoint``)
    at its block; ``ckpt=(path, at_block)`` saves one mid-stream.
    ``batch_blocks=K`` pops K blocks at once, uploads them as one tensor
    and steps the chain K times (the same carry semantics); the remainder
    and the blocks up to a checkpoint run one at a time, so the carry
    exists at exactly ``ckpt[1]`` blocks.  ``warmup=True`` builds and
    loads the CUDA library and the native library before the timed loop
    and touches no carry.  ``drain=True`` streams the whole file: the
    tail zero-padded to whole blocks, extra zero blocks to flush the
    latency, the output exactly ``chain.out_len(num_frames)`` samples
    aligned to position 0, as ``chain.stream(x, block, drain=True)``.
    The seconds run from the producer's start to the last output on the
    host.  ``stats``, when given, receives ``wait_s``, the time this
    thread waited for the ring (the decode holding back the device).
    """
    check(batch_blocks >= 1, "batch_blocks must be >= 1")
    dev = torch.device(device)
    reader = wav_native.WavReader(wav_path)
    stop = threading.Event()
    failed: list[Exception] = []
    th = None
    try:
        check(reader.channels == channels,
              f"WAV has {reader.channels} channels, expected {channels}")
        n_in = reader.num_frames
        if drain:
            check(nblocks is None, "drain streams the whole file (no nblocks)")
            check(resume is None, "drain trims a full-stream output; run restart demos "
                                  "without drain")
            chain.build()
            nblocks = chain.drain_blocks(n_in, block)
            chain.arm_eof(n_in)  # the stages' end-of-file handling, disarmed below
        elif nblocks is None or nblocks > n_in // block:
            nblocks = n_in // block
        check(nblocks >= 1, f"input has {n_in} frames < one {block}-frame block: nothing to "
                            f"stream (drain processes short files)")
        ring = wav_native.RingBuffer(channels, block * max(8, 2 * batch_blocks))
        states = chain.init_state((channels,), block, torch.float32, dev)
        start_block = 0
        if resume:
            states, start_block = load_carry(resume, states)
            check(start_block < nblocks,
                  f"checkpoint is at block {start_block} of {nblocks}: nothing left to resume")

        def producer():
            try:
                for _ in range(start_block):  # restart from a block: skip the processed
                    reader.read_block(block)
                for _ in range(start_block, nblocks):
                    blk = reader.read_block(block)
                    if blk.shape[1] < block:  # past the end of the file (drain only)
                        blk = np.pad(blk, ((0, 0), (0, block - blk.shape[1])))
                    off = 0
                    while off < block:
                        pushed = ring.push(blk[:, off:])
                        off += pushed
                        if pushed == 0:
                            if stop.is_set():
                                return
                            time.sleep(SPIN_S)
            except Exception as err:  # noqa: BLE001 -- the consumer raises it
                failed.append(err)

        if warmup:
            wav_native.lib()
            if dev.type == "cuda":
                from audiosignalprocess_tpu_torch.kernels import _build

                _build.load()

        t_loop = time.perf_counter()
        th = threading.Thread(target=producer, daemon=True)
        th.start()
        outs = []
        wait = 0.0
        bi = start_block
        while bi < nblocks:
            end = nblocks if ckpt is None or bi >= ckpt[1] else min(nblocks, ckpt[1])
            k = batch_blocks if end - bi >= batch_blocks else 1
            t0 = time.perf_counter()
            while ring.readable < block * k:
                if failed:
                    raise RuntimeError(f"the decode thread failed before block {bi}") \
                        from failed[0]
                if not th.is_alive() and ring.readable < block * k:
                    raise RuntimeError(f"the decode thread ended before block {bi}")
                time.sleep(SPIN_S)
            t1 = time.perf_counter()
            wait += t1 - t0
            xb = _upload(ring, block * k, dev)
            for j in range(k):
                states, y = chain.step(states, xb[:, j * block : (j + 1) * block])
                outs.append(_download(y))
            if logger is not None:
                logger.tick(channels * block * k, block_index=bi, blocks=k,
                            step_ms=round(1e3 * (time.perf_counter() - t1), 3),
                            ring_fill=int(ring.readable))
            bi += k
            if ckpt is not None and bi == ckpt[1]:
                save_carry(ckpt[0], states, bi)
        th.join()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t_loop
    finally:
        stop.set()
        if th is not None:
            th.join()
        reader.close()
        if drain:
            chain.disarm_eof()  # end-of-file state is per run
    out = torch.cat(outs, dim=-1).numpy()
    if drain:
        out = out[..., chain.latency : chain.latency + chain.out_len(n_in)]
    if stats is not None:
        stats["wait_s"] = wait
    return out, nblocks - start_block, dt


def _ring_mode(args, x: np.ndarray, chain: Chain, tmp: str) -> None:
    """``--mode ring``: stream the file through ``run_ring`` and check it."""
    wav_path = args.input
    if wav_path is None:  # the generated signal as a float32 WAV
        wav_path = os.path.join(tmp, f"asp_gen_{CHANNELS}ch_{RATE_IN}_s{args.seed}.wav")
        write_wav(wav_path, x, RATE_IN, float_fmt=True)
    x, _ = wav_native.read_wav(wav_path)  # what the ring decodes
    logger = BlockLogger() if args.json or args.bench else None
    stats: dict = {}
    out, nb, dt = run_ring(chain, wav_path, BLOCK, CHANNELS, logger=logger,
                           batch_blocks=args.ring_batch, warmup=args.bench, drain=args.drain,
                           device=args.device, stats=stats)
    x_in = x if args.drain else x[:, : nb * BLOCK]
    snr = None
    if args.check:
        ref = chain.stream(torch.as_tensor(x_in, device=args.device), BLOCK,
                           drain=args.drain).cpu().numpy()
        check(ref.shape == out.shape, f"ring length {out.shape} != stream {ref.shape}")
        exact = np.array_equal(ref, out)
        snr = np.inf if exact else snr_db(ref, out)
        check(exact or snr >= 100.0, f"ring != stream: {snr:.1f} dB")
    extra = {"blocks": nb, "ring_batch": args.ring_batch,
             "ring_wait_share": round(stats["wait_s"] / dt, 4)}
    if args.demo_restart:
        ck = os.path.join(tmp, "asp_cfg5_carry.npz")
        half = max(1, (x.shape[-1] // BLOCK) // 2)
        out_a, _, _ = run_ring(chain, wav_path, BLOCK, CHANNELS, ckpt=(ck, half),
                               batch_blocks=args.ring_batch, device=args.device)
        out_b, _, _ = run_ring(chain, wav_path, BLOCK, CHANNELS, resume=ck,
                               batch_blocks=args.ring_batch, device=args.device)
        tail = out_a[..., half * chain.out_block(BLOCK):]
        check(np.array_equal(tail, out_b), "restart-from-block mismatch")
        extra.update(restart_block=half, restart_tail_bit_equal=True)
        print(f"  restart-from-block verified: resumed at block {half}, "
              f"{out_b.shape[-1]} samples identical")
    maybe_write(args, out, RATE_OUT)
    tag = f"_b{args.ring_batch}" if args.ring_batch > 1 else ""
    report(f"config5_streaming_{CHANNELS}ch_ring{tag}", x_in, out, dt, snr, args,
           ref="stream", bar=100.0, extra=extra)


def main():
    p = std_parser(__doc__)
    p.add_argument("--mode", choices=("stream", "sharded", "ring"), default="stream")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous of a multi-process run without torchrun: host:port or "
                        "an init_method URL")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--demo-restart", action="store_true",
                   help="ring mode: checkpoint mid-stream, restart from the saved block, "
                        "check that the resumed tail is bit-equal")
    p.add_argument("--ring-batch", type=int, default=1, metavar="K",
                   help="ring mode: pop and upload K blocks at once, then K steps")
    p.add_argument("--composite", action="store_true",
                   help="the chain as one ResFIRGateStage: one res_fir_gate_step_fused a block")
    p.add_argument("--drain", action="store_true",
                   help="ring mode: stream the whole file and flush the latency "
                        "(exactly chain.out_len(num_frames) samples)")
    args = p.parse_args()
    coord = args.coordinator
    if coord is not None and "://" not in coord:
        coord = f"tcp://{coord}"
    initialize(coord, args.num_processes, args.process_id, backend=args.backend,
               device=args.device)
    check(args.mode == "sharded" or world() == 1,
          f"--mode {args.mode} runs on one process; --mode sharded spans ranks")

    x = load_or_make(args, channels=CHANNELS, rate=RATE_IN)
    chain = build_chain(fused=not args.no_fused, composite=args.composite)
    lat = chain.build()

    if args.mode == "ring":
        with tempfile.TemporaryDirectory(prefix="asp_cfg5_") as tmp:
            _ring_mode(args, x, chain, tmp)
        return

    mesh = None
    if args.mode == "stream":
        x = x[:, : (x.shape[-1] // BLOCK) * BLOCK]
        xd = torch.as_tensor(x, device=args.device)

        def fn(v):
            return chain.stream(v, BLOCK)
    else:
        tm = world()
        x = x[:, : (x.shape[-1] // (tm * SHARD_QUANTUM)) * (tm * SHARD_QUANTUM)]
        mesh = make_mesh(channel=1, time=tm)
        fn = sharded_chain(mesh, chain)
        xd = shard_audio(torch.as_tensor(x, device=args.device), mesh)

    y, dt = timed(fn, xd) if args.bench else (fn(xd), None)
    out = to_host(y, mesh)

    snr = None
    if args.check:
        full = chain.full(torch.as_tensor(x[:2], dtype=torch.float64)).numpy()
        if args.mode == "stream":
            got = out[:2, lat:]
            snr = snr_db(full[:, : got.shape[-1]], got)
        else:
            check(out.shape[-1] == full.shape[-1], f"sharded length {out.shape} vs {full.shape}")
            snr = snr_db(full, out[:2])
        check(snr >= 60.0, f"parity FAILED: {snr:.1f} dB")

    maybe_write(args, out, RATE_OUT)
    report(f"config5_streaming_{CHANNELS}ch_{args.mode}", x, out, dt, snr, args)


if __name__ == "__main__":
    main()
