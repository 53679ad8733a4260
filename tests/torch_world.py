"""Multi-rank CPU worlds for the port's mesh tests: ``torch.distributed``
over gloo, one spawned process a rank, the rendezvous a file under the
test's tmp_path (so parallel test workers never share a port).  The
children import torch, numpy and the port only: the worker functions live
at module level in test modules that import jax inside their tests, never
at their top."""

from __future__ import annotations

import os
import queue
import time
import traceback

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_SECONDS = 120.0  # a world that has not answered by then has hung


def _entry(fn, rank: int, world: int, rdv: str, results, args) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                                world_size=world)
        out = fn(rank, world, *args)
        dist.barrier()
        results.put((rank, True, out))
    except Exception:  # the parent reports it and stops the world
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """``world`` processes running ``fn(rank, world, *args)`` each; ``join``
    returns their results by rank, or fails the test on an error in any
    rank or when ``timeout`` seconds pass (a hung collective)."""

    def __init__(self, fn, world: int, tmp_path, *args, timeout: float = JOIN_SECONDS):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.results = ctx.Queue()
        rdv = os.path.join(str(tmp_path), f"rdv_{fn.__name__}_{world}_{time.time_ns()}")
        self.procs = [ctx.Process(target=_entry, args=(fn, r, world, rdv, self.results, args),
                                  daemon=True) for r in range(world)]
        self.t0 = time.monotonic()
        for p in self.procs:
            p.start()

    def _stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)

    def join(self) -> list:
        out = {}
        while len(out) < self.world:
            left = self.timeout - (time.monotonic() - self.t0)
            try:
                rank, ok, value = self.results.get(timeout=max(left, 0.1))
            except queue.Empty:
                self._stop()
                pytest.fail(f"world of {self.world} ranks gave no result in "
                            f"{self.timeout:.0f} s (ranks {sorted(out)} answered)")
            if not ok:
                self._stop()
                pytest.fail(f"rank {rank} of {self.world} failed:\n{value}")
            out[rank] = value
        for p in self.procs:
            p.join(max(self.timeout - (time.monotonic() - self.t0), 1.0))
        self._stop()
        return [out[r] for r in range(self.world)]


def mesh_of(world: int, dims):
    """The ranks' mesh: 1-D over the world, or (dp, tp) when ``dims``."""
    from pmf_tpu_torch.parallel import make_mesh, make_mesh_2d

    return make_mesh(world, device="cpu") if dims is None else make_mesh_2d(*dims,
                                                                             device="cpu")


def numpy_state(state: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
