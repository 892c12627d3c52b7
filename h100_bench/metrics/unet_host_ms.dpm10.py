"""Host ms inside each UNet forward of the window, between the forward pre and post hooks."""


def read(r):
    spans = r.get("unet_host_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
