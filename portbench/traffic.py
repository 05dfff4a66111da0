"""The one generator of requests: it reads a mix (``mixes/<traffic>.json``)
and builds each request anew through the port's public API.

A mix is a closed loop of one client.  A request is a list of computes,
run one after another; a compute builds its ops from the held field and
asks for them together:

- ``"deliver": "device"``: one op, ``Array.compute_device()``, then a
  synchronize, so the answer is ready on the card;
- ``"deliver": "host"``: ``Array.compute()`` for one op,
  ``dask_array_tpu_torch.compute(...)`` for several, so the answers are
  numpy on the host.

An op is ``{"name", "op": "map_overlap", "func", "trim"}`` (``func`` a
name in ``funcs.FUNCS``; depth and boundary are the configuration's) or
``{"name", "op": "reduce", "how", "axis"}`` (``how`` an ``Array`` method:
sum, mean, var, std; the configuration's ``split_every`` where it has
one).  ``name`` names the op's answer in the comparison; ops that share a
name are compared as one number, the largest of their gaps.

A request's must-move bytes are the field read once and every answer
written once, from the shapes.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.funcs import FUNCS


class Traffic:
    def __init__(self, mix: dict, cfg: dict):
        if mix.get("loop") != "closed" or mix.get("clients") != 1:
            raise ValueError("the generator runs a closed loop of one client")
        self.mix = mix
        self.cfg = cfg
        self.computes = mix["computes"]
        self.ops = [op for c in self.computes for op in c["ops"]]
        for c in self.computes:
            if c["deliver"] not in ("device", "host"):
                raise ValueError(f"unknown deliver {c['deliver']!r}")
            if c["deliver"] == "device" and len(c["ops"]) != 1:
                raise ValueError("a device compute takes one op")
        for op in self.ops:
            if op["op"] == "map_overlap" and op["func"] not in FUNCS:
                raise ValueError(f"unknown func {op['func']!r}")
            if op["op"] not in ("map_overlap", "reduce"):
                raise ValueError(f"unknown op {op['op']!r}")

    def out_shape(self, op) -> tuple:
        shape = tuple(self.cfg["shape"])
        if op["op"] == "map_overlap":
            return shape
        if op["axis"] is None:
            return ()
        return tuple(s for i, s in enumerate(shape) if i != op["axis"])

    def must_move_bytes(self) -> int:
        item = np.dtype(self.cfg["dtype"]).itemsize
        field = int(np.prod(self.cfg["shape"])) * item
        return field + sum(int(np.prod(self.out_shape(op))) * item for op in self.ops)

    def build(self, da, x, op):
        cfg = self.cfg
        if op["op"] == "map_overlap":
            kw = {"depth": cfg["depth"], "boundary": cfg["boundary"], "dtype": x.dtype}
            if not op.get("trim", True):
                kw.update(trim=False, chunks=x.chunks)
            return da.map_overlap(FUNCS[op["func"]], x, **kw)
        kw = {"axis": op["axis"]}
        if "split_every" in cfg:
            kw["split_every"] = cfg["split_every"]
        return getattr(x, op["how"])(**kw)

    def request(self, da, x, sync, spans) -> list:
        """Run one request; returns its answers in op order.  ``spans``
        collects the seconds spent building the expressions."""
        outs = []
        for c in self.computes:
            t0 = time.perf_counter()
            arrays = [self.build(da, x, op) for op in c["ops"]]
            spans["build"] += time.perf_counter() - t0
            if c["deliver"] == "device":
                outs.append(arrays[0].compute_device())
                sync()
            elif len(arrays) == 1:
                outs.append(np.asarray(arrays[0].compute()))
            else:
                outs.extend(np.asarray(a) for a in da.compute(*arrays))
        return outs
