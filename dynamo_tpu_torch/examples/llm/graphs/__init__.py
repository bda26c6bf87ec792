from dynamo_tpu_torch.examples.llm.graphs import agg, agg_router, disagg, disagg_router

GRAPHS = {
    "agg": agg.launch,
    "agg_router": agg_router.launch,
    "disagg": disagg.launch,
    "disagg_router": disagg_router.launch,
}
