"""Per cent of the traced stretch in which ViT-H/14's training loop
waited for its next batch: the host seconds of the spans around the
calls into the loader's iterator, over the stretch's seconds."""


def read(layer):
    tr = layer.get("trace")
    if layer.get("data_wait_s") is None or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * layer["data_wait_s"] / tr["window_s"]
