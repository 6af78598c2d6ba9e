"""attn_roofline.eval (%): the same as gemm_roofline over the attention cores'
launches (aim_port::spatial_attention, spatial_attention_bwd,
temporal_attention, temporal_attention_bwd, temporal_segment,
temporal_segment_bwd)."""


def read(ctx):
    fam = (ctx.get("rooflines") or {}).get("attn")
    if ctx["kind"] != "eval" or not fam:
        return None
    return 100.0 * fam["bound_s"] / fam["device_s"]
