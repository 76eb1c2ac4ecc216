"""vae_decode_ms_per_frame (ms/frame, device events): the seconds of the VAE
decodes (the CUDA event after a block's DiT to the one after its decode)
over the pixel frames they yielded, in milliseconds."""


def read(rec):
    steps = [st for st in rec.steps if "decode" in st.spans]
    frames = sum(st.frames for st in steps)
    if not frames:
        return None
    return 1e3 * sum(e - s for s, e in (st.spans["decode"] for st in steps)) / frames
