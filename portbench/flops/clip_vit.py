"""CLIP ViT vision tower as LLaVA runs it (up to select_layer) and the
linear projector to the decoder's width."""


def count(clip: dict, d_model: int, batch: int = 1) -> dict:
    e, f = clip["hidden_size"], clip["intermediate_size"]
    p = (clip["image_size"] // clip["patch_size"]) ** 2
    l = p + 1
    layers = clip["num_hidden_layers"] + clip["select_layer"] + 1
    patch = 2 * p * e * 3 * clip["patch_size"] ** 2
    per_layer = 2 * l * (4 * e * e + 2 * e * f) + 2 * 2 * l * l * e
    projector = 2 * p * e * d_model
    return {"flops": batch * (patch + layers * per_layer + projector)}
