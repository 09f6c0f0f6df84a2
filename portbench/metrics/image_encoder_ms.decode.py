"""image_encoder_ms.decode: device ms of the image encoder a served batch,
the mean over the traced run's window of CUDA events recorded by forward
hooks on the program's ``model.encoder_cnn`` (ResNet-18 or ViT-B/16)."""


def read(data: dict):
    spans = data.get("spans", {}).get("image_encoder_ms")
    if not spans:
        return None
    return sum(spans) / len(spans)
