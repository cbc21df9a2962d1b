"""A trainer's loader: a closed loop over ``decode_stream``.

The traffic file gives ``chunk_size``, ``depth``, ``prep_workers`` and
``layout`` as the loader passes them, and ``warm_chunks``. The window
decodes the pool cycled in a fresh seeded order each pass (every pass
holds each image once) and takes the next chunk as soon as the last one
is yielded, until `seconds` have passed; a chunk's images are then
decoded and synchronised on the card. Each chunk is logged with the time
it was yielded, its engine and layout. The fused chunks still in flight
when the window closes count towards the megapixels whose device work
the window ran (``run.mp_device``), not towards those decoded.
"""

from __future__ import annotations

import time

import numpy as np

from ..trace import STEADY, WINDOW, span


def _stream(run, datas):
    t = run.traffic
    return run.port.decode_stream(datas, run.port.DecodeConfig(to_numpy=False), chunk_size=t["chunk_size"],
                                  depth=t["depth"], prep_workers=t["prep_workers"], layout=t["layout"],
                                  device=run.device)


def warm(run) -> None:
    """Every shape the window uses: whole chunks of the cell's images."""
    n = run.traffic["warm_chunks"] * run.traffic["chunk_size"]
    for _chunk in _stream(run, [run.pool[i % len(run.pool)].data for i in range(n)]):
        pass
    run.sync()


def order(run, n: int):
    rng = np.random.default_rng([run.seed % 2**63, 1])
    passes = -(-n // len(run.pool))
    return np.concatenate([rng.permutation(len(run.pool)) for _ in range(passes)])[:n].tolist()


def window(run, seconds: float) -> None:
    cs = run.traffic["chunk_size"]
    # Room for 400 chunks a second: the loop ends on the clock, not the list.
    run.order = order(run, cs * int(400 * seconds + 8))
    datas = [run.pool[i].data for i in run.order]
    tracing = run.trace_on
    steady = None
    gen = _stream(run, datas)
    with span(WINDOW, tracing):
        run.begin()
        while True:
            with span("jpegbench.next_chunk", tracing):
                chunk = next(gen, None)
            if chunk is None:
                break
            t = time.perf_counter()
            failed = 0
            for k, member in enumerate(chunk.members):
                index = run.order[member]
                image = chunk.images[k]
                if member in chunk.failures or image is None:
                    failed += 1
                    continue
                run.mp_done += run.pool[index].mp
                run.offer(index, image, chunk.layout)
            run.attempted += len(chunk.members)
            run.failed += failed
            run.records.append(dict(t=t, first=chunk.members[0] if chunk.members else -1,
                                    n=len(chunk.members), failed=failed, engine=chunk.engine,
                                    layout=chunk.layout))
            if steady is None and tracing:
                steady = span(STEADY, True)
                steady.__enter__()
            if t - run.t0 >= seconds:
                if chunk.engine != "fallback":
                    # The fused stream keeps depth - 1 later chunks launched
                    # on the card: their device work is in the window too.
                    k = len(run.records)
                    run.mp_device += sum(run.pool[i].mp for i in run.order[k * cs:(k + run.traffic["depth"] - 1) * cs])
                break
        run.end()
        if steady is not None:
            steady.__exit__(None, None, None)
    gen.close()
