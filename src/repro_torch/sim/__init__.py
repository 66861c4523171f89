"""The paper's analytic serving simulator (§VI), port of ``repro/sim/``:
host numpy on the cost model, no device and no tensor.

workload.py      synthesized requests: Gaussian lengths, Poisson arrivals
metrics.py       T2FT / TBT / E2E percentiles
paper_models.py  the paper's Table I models and default system sizes
cluster.py       a serving system: devices, links, memory, batch capacity
specs.py         the evaluated systems (GPU, Duplex, Bank-PIM)
layermodel.py    one stage's latency and energy under a policy
engine_sim.py    the continuous-batching event loop and the phase split

Fig. 11's first cell, Mixtral on the paper's 4-GPU node at batch 32::

    from repro_torch.sim import engine_sim, paper_models, specs, workload
    reqs = workload.gaussian_requests(64, 256, 256, seed=11)
    engine_sim.simulate(specs.default_system(paper_models.MIXTRAL, "gpu"),
                        paper_models.MIXTRAL, "gpu", reqs, max_batch=32).throughput
"""
