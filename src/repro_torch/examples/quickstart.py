"""Quickstart: the HAS-GPU core in 60 seconds.

Builds a 2-GPU cluster, deploys a function with a fine-grained allocation,
scales it vertically at runtime (the paper's headline capability), runs the
Kalman-driven hybrid autoscaler against a demand jump, and prints the
resource trajectory.

The port's twin of the JAX package's ``examples/quickstart.py``, its
imports rewritten: the control plane is host numpy in both packages, so
it prints the same numbers.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from repro_torch.configs import ARCHS
from repro_torch.core import (FnSpec, HybridAutoScaler, Reconfigurator,
                              latency, throughput)


def main():
    # --- a serverless inference function: qwen2.5-3b served at batch 8 -------
    spec = FnSpec(ARCHS["qwen2.5-3b"])
    print(f"function: {spec.fn_id}  "
          f"(latency on a whole chip: {latency(spec, 8, 8, 1.0)*1e3:.1f} ms)")

    # --- cluster + autoscaler ------------------------------------------------
    recon = Reconfigurator(num_gpus=2, max_gpus=8)
    scaler = HybridAutoScaler(recon)
    scaler.prewarm(spec, expected_rps=20.0)
    pods = recon.pods_of(spec.fn_id)
    print(f"prewarmed: {[(p.sm, p.quota, p.batch) for p in pods]}")

    # --- fine-grained vertical scaling at runtime ----------------------------
    pod = pods[0]
    gpu = recon.gpu_of_pod(pod.pod_id)
    print(f"pod {pod.pod_id}: sm={pod.sm} quota={pod.quota:.2f} "
          f"thpt={throughput(spec, pod.batch, pod.sm, pod.quota):.1f} rps")
    new_q = min(1.0, pod.quota + 0.3)
    gpu.set_quota(pod.pod_id, new_q)  # runtime quota rewrite — no restart
    print(f"vertical scale-up to q={new_q:.2f}: "
          f"thpt={throughput(spec, pod.batch, pod.sm, pod.quota):.1f} rps")

    # --- hybrid autoscaling under a demand ramp ------------------------------
    print("\nt(s)  observed_rps  pods  alloc(GPU-fractions)  actions")
    for t, rps in enumerate([20, 22, 30, 80, 160, 150, 40, 10, 8, 8]):
        actions = scaler.tick(float(t * 21), spec, float(rps))
        pods = recon.pods_of(spec.fn_id)
        alloc = sum(p.sm / 8 * p.quota for p in pods)
        acts = ";".join(f"{a.kind}" for a in actions) or "-"
        print(f"{t*21:4d}  {rps:12.0f}  {len(pods):4d}  {alloc:18.2f}  {acts}")

    print(f"\ncluster GPUs in use: {len(recon.used_gpus())}, "
          f"invariants ok: {recon.invariant_ok()}")
    return recon


if __name__ == "__main__":
    main()
