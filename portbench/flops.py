"""Model FLOPs from the published layer shapes, 2 a multiply-add, shared
by the MFU metrics (metrics/train_mfu.py, metrics/serve_mfu.stream.py).

`dgcnn_forward_flops`: every Dense layer of a DGCNN cloud's forward on the
points or edges it maps: EdgeConv layer widths on the N*k edges, the
global Dense on the N points, the head on the N points; normalisation,
activations, maxima and the graph are not counted.

`cnn_flops`: MobileNetASPP's whole-volume forward counted from its
convolution shapes (chip_smoke.py's `_cnn_flops` by conv kind: each dense
conv in x taps x out per output voxel, each depthwise 27 per output
value), on the CT edge-padded to multiples of 4."""


def dgcnn_forward_flops(cfg, n_points: int) -> int:
    """FLOPs of one cloud's forward."""
    k = cfg["k"]
    edges = n_points * k
    flops, cin = 0, cfg["in_features"]
    for widths in cfg["edge_widths"]:
        fin = 2 * cin
        for w in widths:
            flops += 2 * fin * w * edges
            fin = w
        cin = widths[-1]
    multi = sum(w[-1] for w in cfg["edge_widths"])
    flops += 2 * multi * cfg["global_width"] * n_points
    fin = multi + cfg["global_width"]
    for w in (*cfg["head_widths"], cfg["num_classes"]):
        flops += 2 * fin * w * n_points
        fin = w
    return flops


def cnn_flops(config) -> int:
    d, h, w = (-(-s // 4) * 4 for s in config["ct_shape"])
    full = d * h * w
    half = full // 8
    quarter = half // 8
    flops, cin = 0, config["in_channels"]
    vox = half
    for i, (mid, out, stride, first) in enumerate(config["blocks"]):
        taps = 27 if first else 1
        flops += 2 * taps * cin * mid * vox           # expand (stem)
        vout = vox // 8 if stride == 2 else vox
        flops += 2 * 27 * mid * vout                  # depthwise
        flops += 2 * mid * out * vout                 # project
        vox, cin = vout, out
    a, rates = config["aspp_width"], config["aspp_rates"]
    flops += 2 * cin * a * quarter                    # 1x1 branch
    flops += len(rates) * 2 * 27 * cin * a * quarter  # dilated branches
    flops += 2 * cin * a                              # pooled branch
    flops += 2 * a * (len(rates) + 2) * a * quarter   # projection
    skip = config["blocks"][0][1]
    dec = config["decoder_width"]
    flops += 2 * (skip + a) * dec * half
    flops += 2 * 27 * dec * dec * half
    flops += 2 * dec * config["num_classes"] * half
    return flops
