"""Gateway: request entry point + throughput-weighted load balancing
across a function's pod engines (paper: 'the load balancer is updated with
request distribution information according to the throughput capability of
different function pods').

A copy of the JAX package's gateway, bound to the port's ``PodEngine``."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.gpus import DEFAULT_GPU_TYPE
from repro_torch.core.perf_model import FnSpec, throughput
from repro_torch.serving.batcher import InferenceRequest
from repro_torch.serving.engine import PodEngine


class Gateway:
    def __init__(self):
        self.engines: Dict[str, List[PodEngine]] = {}
        # per-config roofline throughput memo for the routing score:
        # recomputing the roofline on every routed request made route()
        # O(predictor) per request; the score only changes when a pod's
        # (batch, sm, quota, device) changes
        self._thpt_cache: Dict[tuple, float] = {}

    def register(self, fn_id: str, engine: PodEngine) -> None:
        self.engines.setdefault(fn_id, []).append(engine)

    def deregister(self, fn_id: str, pod_id: str) -> None:
        pods = self.engines.get(fn_id)
        if pods is None:
            return
        pods = [e for e in pods if e.pod.pod_id != pod_id]
        if pods:
            self.engines[fn_id] = pods
        else:
            # prune the key: a fully drained function is unknown again
            # (route() raises, and the fn_id list stays truthful)
            del self.engines[fn_id]

    def _pod_throughput(self, e: PodEngine) -> float:
        """The pod's roofline throughput on its own device, memoized per
        (fn, batch, sm, quota, device type) — a quota rewrite lands on a
        fresh key, so runtime vertical scaling stays correct."""
        t = e.pod.gpu_type or DEFAULT_GPU_TYPE
        key = (e.spec.fn_id, e.pod.batch, e.pod.sm, e.pod.quota, t.name)
        v = self._thpt_cache.get(key)
        if v is None:
            v = throughput(e.spec, e.pod.batch, e.pod.sm, e.pod.quota, gpu=t)
            self._thpt_cache[key] = v
        return v

    def route(self, fn_id: str, req: InferenceRequest) -> PodEngine:
        pods = self.engines.get(fn_id)
        if not pods:
            known = ", ".join(sorted(self.engines)) or "<none>"
            raise KeyError(
                f"no pods for {fn_id!r}; registered fn_ids: {known}")
        # doomed (reclaim grace window) and quarantined (health-tripped
        # straggler, core/faults.py) pods take no new requests — unless
        # literally nothing else serves this function
        live = [e for e in pods
                if not e.pod.doomed and not e.pod.quarantined] or pods
        # least normalized backlog: queue / predicted throughput on the
        # pod's OWN device — on a mixed fleet, capability differs per chip
        eng = min(live, key=lambda e: (len(e.batcher.queue)
                                       / max(self._pod_throughput(e), 1e-9)))
        eng.submit(req)
        return eng

    def pump(self, fn_id: str) -> List[InferenceRequest]:
        done = []
        for e in self.engines.get(fn_id, []):
            done.extend(e.step())
        return done
