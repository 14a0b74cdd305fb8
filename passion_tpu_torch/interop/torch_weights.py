"""Reference PyTorch checkpoints -> port state_dicts (counterpart of
`passion_tpu/interop/torch_weights.py`).

A researcher who trained with the upstream PASSION code (`model_last.pth`,
saved as `{epoch, state_dict, optim_dict}`, DataParallel's `module.`
prefix on every key) evaluates or fine-tunes those weights here:

    sd = load_torch_checkpoint("model_last.pth")
    model = get_model("rfnet")
    model.load_state_dict(rfnet_params_from_torch(sd), strict=True)

Each backbone's mapping is one declarative table of
`(upstream key, port key, modality slot or None)` rows, built by the same
loops as the JAX package's converter, so it can be read in both
directions. Torch layouts need almost no transform:
  * conv weights stay (O, I, k, k, k);
  * the four per-modality upstream encoders are one `groups=4` conv per
    layer in the port: rows with slots 0-3 (`TORCH_MODALITIES` order) are
    concatenated on dim 0, modality-major (mmFormer's per-modality `pos`,
    which is no conv, is stacked on a new dim 0 instead);
  * RFNet's `modal_fusion.{r}.weight_layer.0/.2` are 1x1x1 convs upstream
    and `nn.Linear`s (`fc1`, `fc2`) in the port: reshaped to (O, I);
  * `nn.Linear` and `nn.LayerNorm` map one to one; InstanceNorm has no
    parameters (affine=False upstream).
Upstream keys outside the table are ignored, as the JAX converter ignores
them; a key the table needs and `sd` lacks raises `KeyError`, naming it and
the port key it would fill.
"""

from __future__ import annotations

import torch

# reference modality encoder attribute order (rfnet.py:178-186): the
# canonical channel order FLAIR, T1ce, T1, T2 (masks.MODALITIES)
TORCH_MODALITIES = ("flair", "t1ce", "t1", "t2")

_ENC_LAYERS = tuple(f"e{i}_c{j}" for i in (1, 2, 3, 4) for j in (1, 2, 3))
_SEP_LAYERS = ("d3_c1", "d3_c2", "d3_out", "d2_c1", "d2_c2", "d2_out",
               "d1_c1", "d1_c2", "d1_out")
_DEC_LAYERS = ("d4_c1", "d4_c2", "d4_out") + _SEP_LAYERS
_LINEAR_FROM_CONV = ("fc1.weight", "fc2.weight")


def load_torch_checkpoint(path) -> dict[str, torch.Tensor]:
    """A reference checkpoint (`torch.save({'state_dict': ...})`,
    train.py:359-364 upstream, or a bare state_dict) as {name: float32
    tensor on the CPU}, with DataParallel's 'module.' prefix stripped. The
    upstream files hold only `epoch`, `state_dict` and `optim_dict`, which
    `weights_only` loading accepts."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob)
    return {k.removeprefix("module."): v.detach().to(torch.float32)
            for k, v in sd.items()}


Table = list[tuple[str, str, int | None]]


def _param(rows: Table, up: str, port: str, names=("weight", "bias")):
    rows += [(f"{up}.{n}", f"{port}.{n}", None) for n in names]


def _grouped(rows: Table, ups: list[str], port: str):
    """One port `groups=4` conv from the four per-modality upstream convs."""
    for n in ("weight", "bias"):
        rows += [(f"{up}.{n}", f"{port}.{n}", slot)
                 for slot, up in enumerate(ups)]


def _transformer(rows: Table, up: str, port: str, depth: int):
    """Reference Transformer (mmformer.py:280-311: per layer
    Residual(PreNormDrop(LN, SelfAttention)) + Residual(PreNorm(LN, FFN));
    qkv without bias) -> the port's `layers.{j}`."""
    for j in range(depth):
        att = f"{up}.cross_attention_list.{j}.fn"
        ffn = f"{up}.cross_ffn_list.{j}.fn"
        ours = f"{port}.layers.{j}"
        _param(rows, f"{att}.norm", f"{ours}.attn_norm")
        _param(rows, f"{att}.fn.qkv", f"{ours}.attn.qkv", ("weight",))
        _param(rows, f"{att}.fn.proj", f"{ours}.attn.proj")
        _param(rows, f"{ffn}.norm", f"{ours}.ffn_norm")
        _param(rows, f"{ffn}.fn.net.0", f"{ours}.ffn.fc1")
        _param(rows, f"{ffn}.fn.net.3", f"{ours}.ffn.fc2")


def mmformer_table(depth: int = 1) -> Table:
    """Reference mmformer.Model keys -> the port's MMFormer (reference
    mmformer.py:328-446, blocks.py:300-316,533-542)."""
    rows: Table = []
    # e1_c1 is a bare Conv3d (mmformer.py:28); the rest are prenorm convs
    _grouped(rows, [f"{m}_encoder.e1_c1" for m in TORCH_MODALITIES],
             "encoders.e1_c1")
    for layer in [f"e{i}_c{j}" for i in (1, 2, 3, 4, 5) for j in (1, 2, 3)
                  if (i, j) != (1, 1)]:
        _grouped(rows, [f"{m}_encoder.{layer}.conv" for m in TORCH_MODALITIES],
                 f"encoders.{layer}.conv")
    _grouped(rows, [f"{m}_encode_conv" for m in TORCH_MODALITIES],
             "encode_convs")
    rows += [(f"{m}_pos", "pos", slot)
             for slot, m in enumerate(TORCH_MODALITIES)]
    for slot, m in enumerate(TORCH_MODALITIES):
        _transformer(rows, f"{m}_transformer", f"intra_transformers.{slot}",
                     depth)

    fp = "fuse_path"
    _transformer(rows, "multimodal_transformer",
                 f"{fp}.multimodal_transformer", depth)
    _param(rows, "multimodal_decode_conv", f"{fp}.multimodal_decode_conv")
    for layer in _DEC_LAYERS:
        _param(rows, f"decoder_fuse.{layer}.conv",
               f"{fp}.decoder_fuse.{layer}.conv")
    for head in ("seg_d4", "seg_d3", "seg_d2", "seg_d1", "seg_layer"):
        _param(rows, f"decoder_fuse.{head}", f"{fp}.decoder_fuse.{head}")
    for k in (1, 2, 3, 4, 5):
        for i in range(3):
            _param(rows, f"decoder_fuse.RFM{k}.fusion_layer.{i}.conv",
                   f"{fp}.decoder_fuse.RFM{k}.layers.{i}.conv")

    for layer in _DEC_LAYERS:
        _param(rows, f"decoder_sep.{layer}.conv", f"decoder_sep.{layer}.conv")
    _param(rows, "decoder_sep.seg_layer", "decoder_sep.seg_layer")
    return rows


def _ln_conv_block(rows: Table, up: str, port: str, convs: tuple[str, ...]):
    """torch DepthWiseConvBlock / GroupConvBlock (blocks.py:32-109): three
    convs, each followed by a channel LayerNorm -> `convs.N`, `norms.N`."""
    for n, conv in enumerate(convs):
        _param(rows, f"{up}.{conv}", f"{port}.convs.{n}")
        _param(rows, f"{up}.norm{n + 1}", f"{port}.norms.{n}")


def _multi_cross_token(rows: Table, up: str, port: str, num_layers: int = 2):
    """torch MultiCrossToken (m2ftrans.py:25-61). The port's last layer has
    no `ffn2` (it leaves the feature maps alone); an upstream one is not
    read."""
    dw, group = ("conv1", "conv2", "conv3"), ("pwconv1", "dwconv", "pwconv2")
    for i in range(num_layers):
        ln, ours = f"{up}.layers.{i}", f"{port}.layer_{i}"
        maps = ["query_map", "out_project"] + [
            f"{kv}_map_{m}" for m in TORCH_MODALITIES
            for kv in ("key", "value")]
        for name in maps:
            _ln_conv_block(rows, f"{ln}.cross_attn.{name}",
                           f"{ours}.cross_attn.{name}", dw)
        _ln_conv_block(rows, f"{ln}.ffn1", f"{ours}.ffn1", group)
        if i != num_layers - 1:
            _ln_conv_block(rows, f"{ln}.ffn2", f"{ours}.ffn2", group)


def m2ftrans_table(depth: int = 3) -> Table:
    """Reference m2ftrans.Model keys -> the port's M2FTrans (reference
    m2ftrans.py:63-241,399-566, blocks.py:32-109,206-297)."""
    rows: Table = []
    for layer in [f"e{i}_c{j}" for i in (1, 2, 3, 4, 5) for j in (1, 2, 3)]:
        _grouped(rows, [f"{m}_encoder.{layer}.conv" for m in TORCH_MODALITIES],
                 f"encoders.{layer}.conv")
    rows += [("pos", "pos", None), ("fusion", "fusion", None)]

    _transformer(rows, "Bottleneck.trans_bottle", "fuse_path.trans_bottle",
                 depth)
    df = "fuse_path.decoder_fusion"
    for layer in ("d5_c2", "d5_out") + _DEC_LAYERS:
        _param(rows, f"decoder_fusion.{layer}.conv", f"{df}.{layer}.conv")
    _param(rows, "decoder_fusion.seg_layer", f"{df}.seg_layer")
    for k in (1, 2, 3):
        for i in range(3):
            _param(rows, f"decoder_fusion.RFM{k}.fusion_layer.{i}.conv",
                   f"{df}.RFM{k}.layers.{i}.conv")
    for k in (1, 2, 3, 4, 5):
        prm = f"decoder_fusion.prm_fusion{k}.prm_layer"
        _param(rows, f"{prm}.0.conv", f"{df}.prm_fusion{k}.layers.0.conv")
        _param(rows, f"{prm}.1", f"{df}.prm_fusion{k}.conv")
    for ct in ("CT5", "CT4"):
        _multi_cross_token(rows, f"decoder_fusion.{ct}", f"{df}.{ct}")

    for layer in _DEC_LAYERS:
        _param(rows, f"decoder_sep.{layer}.conv", f"decoder_sep.{layer}.conv")
    _param(rows, "decoder_sep.seg_layer", "decoder_sep.seg_layer")
    return rows


def rfnet_table() -> Table:
    """Reference rfnet.Model keys -> the port's RFNet (reference
    rfnet.py:176-244, blocks.py:372-626)."""
    rows: Table = []
    for layer in _ENC_LAYERS:
        _grouped(rows, [f"{m}_encoder.{layer}.conv" for m in TORCH_MODALITIES],
                 f"encoders.{layer}.conv")
    for dec in ("decoder_sep", "decoder_fuse"):
        for layer in _SEP_LAYERS:
            _param(rows, f"{dec}.{layer}.conv", f"{dec}.{layer}.conv")
        _param(rows, f"{dec}.seg_layer", f"{dec}.seg_layer")

    for k in (1, 2, 3, 4):  # same module paths upstream and in the port
        prm = f"decoder_fuse.prm_generator{k}"
        for i in range(3):
            _param(rows, f"{prm}.embedding_layer.{i}.conv",
                   f"{prm}.embedding_layer.layers.{i}.conv")
        _param(rows, f"{prm}.prm_layer.0.conv", f"{prm}.layers.0.conv")
        _param(rows, f"{prm}.prm_layer.1", f"{prm}.conv")

        rfm = f"decoder_fuse.RFM{k}"
        for r in range(4):
            _param(rows, f"{rfm}.modal_fusion.{r}.weight_layer.0",
                   f"{rfm}.modal_fusion_{r}.fc1")
            _param(rows, f"{rfm}.modal_fusion.{r}.weight_layer.2",
                   f"{rfm}.modal_fusion_{r}.fc2")
        for i in range(3):
            _param(rows, f"{rfm}.region_fusion.fusion_layer.{i}.conv",
                   f"{rfm}.region_fusion_c{i + 1}.conv")
            _param(rows, f"{rfm}.short_cut.{i}.conv",
                   f"{rfm}.layers.{i}.conv")
    return rows


def _from_table(sd, table: Table) -> dict[str, torch.Tensor]:
    """Port state_dict from an upstream state_dict (tensors or numpy
    arrays) by `table`: slotted rows concatenated (conv weights and biases)
    or stacked (`pos`) on dim 0 in slot order; a 1x1x1 conv weight that
    fills a Linear reshaped to (O, I)."""
    parts: dict[str, list] = {}
    for up, port, slot in table:
        if up not in sd:
            raise KeyError(f"the upstream state_dict has no {up!r} (for the "
                           f"port's {port!r})")
        parts.setdefault(port, []).append((slot, up))
    out = {}
    for port, rows in parts.items():
        ts = [torch.as_tensor(sd[up]).detach().to(torch.float32)
              for _, up in rows]
        if rows[0][0] is None:
            (t,) = ts
            if t.ndim == 5 and port.endswith(_LINEAR_FROM_CONV):
                t = t.flatten(1)
        elif port.endswith((".weight", ".bias")):
            t = torch.cat(ts, dim=0)
        else:
            t = torch.stack(ts, dim=0)
        out[port] = t.clone().contiguous()
    return out


def mmformer_params_from_torch(sd, depth: int = 1) -> dict[str, torch.Tensor]:
    """Reference mmformer.Model state_dict -> the port MMFormer's."""
    return _from_table(sd, mmformer_table(depth))


def m2ftrans_params_from_torch(sd, depth: int = 3) -> dict[str, torch.Tensor]:
    """Reference m2ftrans.Model state_dict -> the port M2FTrans's."""
    return _from_table(sd, m2ftrans_table(depth))


def rfnet_params_from_torch(sd) -> dict[str, torch.Tensor]:
    """Reference rfnet.Model state_dict -> the port RFNet's."""
    return _from_table(sd, rfnet_table())
