"""Programmatic model definitions: the LeNet -> CIFAR -> AlexNet/CaffeNet ->
GoogLeNet progression of the reference (caffe/examples/mnist,
caffe/examples/cifar10, caffe/models/bvlc_reference_caffenet,
caffe/models/bvlc_googlenet), re-expressed with the DSL so the framework is
self-contained — no prototxt files needed (though stock ones load too).
"""

from .dsl import (NetParam, RDDLayer, ConvolutionLayer, PoolingLayer,
                  InnerProductLayer, ReLULayer, SoftmaxWithLoss,
                  AccuracyLayer, LRNLayer, DropoutLayer, ConcatLayer,
                  EltwiseLayer, AttentionLayer, EmbedLayer,
                  PositionalEmbedLayer, LayerNormLayer, MoELayer, _base)


def _conv(name, bottom, num_output, kernel, stride=1, pad=0, group=None,
          w_std=0.01, w_type="gaussian", bias_value=0.0, lr=(1, 2),
          decay=(1, 0)):
    wf = dict(type=w_type)
    if w_type == "gaussian":
        wf["std"] = w_std
    lp = ConvolutionLayer(
        name, [bottom], (kernel, kernel), num_output,
        stride=(stride, stride), pad=(pad, pad), group=group,
        weight_filler=wf,
        bias_filler=dict(type="constant", value=bias_value),
        param=[dict(lr_mult=lr[0], decay_mult=decay[0]),
               dict(lr_mult=lr[1], decay_mult=decay[1])])
    return lp


def _fc(name, bottom, num_output, w_std=0.01, w_type="gaussian",
        bias_value=0.0, lr=(1, 2), decay=(1, 0)):
    wf = dict(type=w_type)
    if w_type == "gaussian":
        wf["std"] = w_std
    return InnerProductLayer(
        name, [bottom], num_output, weight_filler=wf,
        bias_filler=dict(type="constant", value=bias_value),
        param=[dict(lr_mult=lr[0], decay_mult=decay[0]),
               dict(lr_mult=lr[1], decay_mult=decay[1])])


def lenet(batch_size=64, with_data=True):
    """LeNet on 28x28x1 (reference examples/mnist/lenet_train_test.prototxt)."""
    layers = []
    if with_data:
        layers += [RDDLayer("data", [batch_size, 1, 28, 28]),
                   RDDLayer("label", [batch_size])]
    layers += [
        _conv("conv1", "data", 20, 5, w_type="xavier"),
        PoolingLayer("pool1", ["conv1"], "MAX", (2, 2), (2, 2)),
        _conv("conv2", "pool1", 50, 5, w_type="xavier"),
        PoolingLayer("pool2", ["conv2"], "MAX", (2, 2), (2, 2)),
        _fc("ip1", "pool2", 500, w_type="xavier"),
        ReLULayer("relu1", ["ip1"], tops=["ip1"]),
        _fc("ip2", "ip1", 10, w_type="xavier"),
        AccuracyLayer("accuracy", ["ip2", "label"]),
        SoftmaxWithLoss("loss", ["ip2", "label"]),
    ]
    return NetParam("LeNet", *layers)


def cifar10_full(batch_size=100, with_data=True):
    """CIFAR10_full (reference examples/cifar10/cifar10_full_train_test.prototxt)."""
    layers = []
    if with_data:
        layers += [RDDLayer("data", [batch_size, 3, 32, 32]),
                   RDDLayer("label", [batch_size])]
    layers += [
        _conv("conv1", "data", 32, 5, pad=2, w_std=0.0001, lr=(1, 2),
              decay=(1, 1)),
        PoolingLayer("pool1", ["conv1"], "MAX", (3, 3), (2, 2)),
        ReLULayer("relu1", ["pool1"], tops=["pool1"]),
        LRNLayer("norm1", ["pool1"], local_size=3, alpha=5e-5, beta=0.75,
                 norm_region="WITHIN_CHANNEL"),
        _conv("conv2", "norm1", 32, 5, pad=2, w_std=0.01, decay=(1, 1)),
        ReLULayer("relu2", ["conv2"], tops=["conv2"]),
        PoolingLayer("pool2", ["conv2"], "AVE", (3, 3), (2, 2)),
        LRNLayer("norm2", ["pool2"], local_size=3, alpha=5e-5, beta=0.75,
                 norm_region="WITHIN_CHANNEL"),
        _conv("conv3", "norm2", 64, 5, pad=2, w_std=0.01, lr=(1, 1),
              decay=(1, 1)),
        ReLULayer("relu3", ["conv3"], tops=["conv3"]),
        PoolingLayer("pool3", ["conv3"], "AVE", (3, 3), (2, 2)),
        InnerProductLayer(
            "ip1", ["pool3"], 10,
            weight_filler=dict(type="gaussian", std=0.01),
            bias_filler=dict(type="constant"),
            param=[dict(lr_mult=1, decay_mult=250),
                   dict(lr_mult=2, decay_mult=0)]),
        AccuracyLayer("accuracy", ["ip1", "label"]),
        SoftmaxWithLoss("loss", ["ip1", "label"]),
    ]
    return NetParam("CIFAR10_full", *layers)


def cifar10_full_sigmoid_bn(batch_size=100, with_data=True):
    """CIFAR10_full with sigmoids and BatchNorm, after the layer list of
    Caffe's examples/cifar10/cifar10_full_sigmoid_train_test_bn.prototxt:
    three 5x5 pad-2 convolutions (32, 32, 64 outputs) without bias, each
    with a BatchNorm (its three state blobs at lr_mult 0) and a Sigmoid;
    MAX then AVE 3/2 pooling; ip1 of 10 outputs and the loss. The port's
    own (the JAX zoo has no such net): it carries every layer of the
    stock BN nets that the older zoo nets lack."""
    def conv(name, bottom, num_output, std):
        return _base("Convolution", name, [bottom], convolution_param=dict(
            num_output=num_output, pad=[2], kernel_size=[5], stride=[1],
            bias_term=False, weight_filler=dict(type="gaussian", std=std)),
            param=[dict(lr_mult=1)])

    def bn(name, bottom):
        return _base("BatchNorm", name, [bottom],
                     param=[dict(lr_mult=0)] * 3)

    def sigmoid(name, bottom):
        return _base("Sigmoid", name, [bottom])

    layers = []
    if with_data:
        layers += [RDDLayer("data", [batch_size, 3, 32, 32]),
                   RDDLayer("label", [batch_size])]
    layers += [
        conv("conv1", "data", 32, 0.0001),
        PoolingLayer("pool1", ["conv1"], "MAX", (3, 3), (2, 2)),
        bn("bn1", "pool1"), sigmoid("Sigmoid1", "bn1"),
        conv("conv2", "Sigmoid1", 32, 0.01),
        bn("bn2", "conv2"), sigmoid("Sigmoid2", "bn2"),
        PoolingLayer("pool2", ["Sigmoid2"], "AVE", (3, 3), (2, 2)),
        conv("conv3", "pool2", 64, 0.01),
        bn("bn3", "conv3"), sigmoid("Sigmoid3", "bn3"),
        PoolingLayer("pool3", ["Sigmoid3"], "AVE", (3, 3), (2, 2)),
        InnerProductLayer(
            "ip1", ["pool3"], 10,
            weight_filler=dict(type="gaussian", std=0.01),
            bias_filler=dict(type="constant"),
            param=[dict(lr_mult=1, decay_mult=250),
                   dict(lr_mult=0.2, decay_mult=0)]),
        AccuracyLayer("accuracy", ["ip1", "label"]),
        SoftmaxWithLoss("loss", ["ip1", "label"]),
    ]
    return NetParam("CIFAR10_full_sigmoid_bn", *layers)


def caffenet(batch_size=256, num_classes=1000, with_data=True,
             crop_size=227):
    """AlexNet-class CaffeNet (reference models/bvlc_reference_caffenet/
    train_val.prototxt): the pool-then-norm AlexNet variant with grouped
    conv2/4/5 — the ImageNetApp workload (ImageNetApp.scala)."""
    layers = []
    if with_data:
        layers += [RDDLayer("data", [batch_size, 3, crop_size, crop_size]),
                   RDDLayer("label", [batch_size])]
    layers += [
        _conv("conv1", "data", 96, 11, stride=4, w_std=0.01),
        ReLULayer("relu1", ["conv1"], tops=["conv1"]),
        PoolingLayer("pool1", ["conv1"], "MAX", (3, 3), (2, 2)),
        LRNLayer("norm1", ["pool1"], local_size=5, alpha=1e-4, beta=0.75),
        _conv("conv2", "norm1", 256, 5, pad=2, group=2, w_std=0.01,
              bias_value=1.0),
        ReLULayer("relu2", ["conv2"], tops=["conv2"]),
        PoolingLayer("pool2", ["conv2"], "MAX", (3, 3), (2, 2)),
        LRNLayer("norm2", ["pool2"], local_size=5, alpha=1e-4, beta=0.75),
        _conv("conv3", "norm2", 384, 3, pad=1, w_std=0.01),
        ReLULayer("relu3", ["conv3"], tops=["conv3"]),
        _conv("conv4", "conv3", 384, 3, pad=1, group=2, w_std=0.01,
              bias_value=1.0),
        ReLULayer("relu4", ["conv4"], tops=["conv4"]),
        _conv("conv5", "conv4", 256, 3, pad=1, group=2, w_std=0.01,
              bias_value=1.0),
        ReLULayer("relu5", ["conv5"], tops=["conv5"]),
        PoolingLayer("pool5", ["conv5"], "MAX", (3, 3), (2, 2)),
        _fc("fc6", "pool5", 4096, w_std=0.005, bias_value=1.0),
        ReLULayer("relu6", ["fc6"], tops=["fc6"]),
        DropoutLayer("drop6", ["fc6"], tops=["fc6"], ratio=0.5),
        _fc("fc7", "fc6", 4096, w_std=0.005, bias_value=1.0),
        ReLULayer("relu7", ["fc7"], tops=["fc7"]),
        DropoutLayer("drop7", ["fc7"], tops=["fc7"], ratio=0.5),
        _fc("fc8", "fc7", num_classes, w_std=0.01),
        AccuracyLayer("accuracy", ["fc8", "label"]),
        SoftmaxWithLoss("loss", ["fc8", "label"]),
    ]
    return NetParam("CaffeNet", *layers)


# GoogLeNet inception tower widths (models/bvlc_googlenet/train_val.prototxt)
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def _gconv(name, bottom, num_output, kernel, stride=1, pad=0):
    return _conv(name, bottom, num_output, kernel, stride=stride, pad=pad,
                 w_type="xavier", bias_value=0.2)


def _inception(name, bottom, widths):
    n1, r3, n3, r5, n5, pp = widths
    p = f"inception_{name}"
    layers = [
        _gconv(f"{p}/1x1", bottom, n1, 1),
        ReLULayer(f"{p}/relu_1x1", [f"{p}/1x1"], tops=[f"{p}/1x1"]),
        _gconv(f"{p}/3x3_reduce", bottom, r3, 1),
        ReLULayer(f"{p}/relu_3x3_reduce", [f"{p}/3x3_reduce"],
                  tops=[f"{p}/3x3_reduce"]),
        _gconv(f"{p}/3x3", f"{p}/3x3_reduce", n3, 3, pad=1),
        ReLULayer(f"{p}/relu_3x3", [f"{p}/3x3"], tops=[f"{p}/3x3"]),
        _gconv(f"{p}/5x5_reduce", bottom, r5, 1),
        ReLULayer(f"{p}/relu_5x5_reduce", [f"{p}/5x5_reduce"],
                  tops=[f"{p}/5x5_reduce"]),
        _gconv(f"{p}/5x5", f"{p}/5x5_reduce", n5, 5, pad=2),
        ReLULayer(f"{p}/relu_5x5", [f"{p}/5x5"], tops=[f"{p}/5x5"]),
        PoolingLayer(f"{p}/pool", [bottom], "MAX", (3, 3), (1, 1), pad=1),
        _gconv(f"{p}/pool_proj", f"{p}/pool", pp, 1),
        ReLULayer(f"{p}/relu_pool_proj", [f"{p}/pool_proj"],
                  tops=[f"{p}/pool_proj"]),
        ConcatLayer(f"{p}/output",
                    [f"{p}/1x1", f"{p}/3x3", f"{p}/5x5", f"{p}/pool_proj"]),
    ]
    return layers, f"{p}/output"


def _aux_head(idx, bottom, num_classes):
    p = f"loss{idx}"
    layers = [
        PoolingLayer(f"{p}/ave_pool", [bottom], "AVE", (5, 5), (3, 3)),
        _gconv(f"{p}/conv", f"{p}/ave_pool", 128, 1),
        ReLULayer(f"{p}/relu_conv", [f"{p}/conv"], tops=[f"{p}/conv"]),
        _fc(f"{p}/fc", f"{p}/conv", 1024, w_type="xavier", bias_value=0.2),
        ReLULayer(f"{p}/relu_fc", [f"{p}/fc"], tops=[f"{p}/fc"]),
        DropoutLayer(f"{p}/drop_fc", [f"{p}/fc"], tops=[f"{p}/fc"],
                     ratio=0.7),
        _fc(f"{p}/classifier", f"{p}/fc", num_classes, w_type="xavier"),
    ]
    loss = SoftmaxWithLoss(f"{p}/loss", [f"{p}/classifier", "label"])
    loss.clear("top")
    # the stock prototxt names BOTH aux loss tops ".../loss1"
    # (bvlc_googlenet/train_val.prototxt) — keep the quirk for parity
    loss.top.append(f"{p}/loss{1 if idx == 2 else idx}")
    loss.loss_weight.append(0.3)
    layers.append(loss)
    layers.append(AccuracyLayer(f"{p}/top-1", [f"{p}/classifier", "label"]))
    return layers


def googlenet(batch_size=32, num_classes=1000, with_data=True,
              with_aux=True):
    """GoogLeNet (reference models/bvlc_googlenet/train_val.prototxt):
    9 inception modules, 2 auxiliary train-time classifiers at 0.3 weight."""
    layers = []
    if with_data:
        layers += [RDDLayer("data", [batch_size, 3, 224, 224]),
                   RDDLayer("label", [batch_size])]
    layers += [
        _gconv("conv1/7x7_s2", "data", 64, 7, stride=2, pad=3),
        ReLULayer("conv1/relu_7x7", ["conv1/7x7_s2"], tops=["conv1/7x7_s2"]),
        PoolingLayer("pool1/3x3_s2", ["conv1/7x7_s2"], "MAX", (3, 3), (2, 2)),
        LRNLayer("pool1/norm1", ["pool1/3x3_s2"], local_size=5, alpha=1e-4,
                 beta=0.75),
        _gconv("conv2/3x3_reduce", "pool1/norm1", 64, 1),
        ReLULayer("conv2/relu_3x3_reduce", ["conv2/3x3_reduce"],
                  tops=["conv2/3x3_reduce"]),
        _gconv("conv2/3x3", "conv2/3x3_reduce", 192, 3, pad=1),
        ReLULayer("conv2/relu_3x3", ["conv2/3x3"], tops=["conv2/3x3"]),
        LRNLayer("conv2/norm2", ["conv2/3x3"], local_size=5, alpha=1e-4,
                 beta=0.75),
        PoolingLayer("pool2/3x3_s2", ["conv2/norm2"], "MAX", (3, 3), (2, 2)),
    ]
    bottom = "pool2/3x3_s2"
    for key in ("3a", "3b"):
        ls, bottom = _inception(key, bottom, _INCEPTION[key])
        layers += ls
    layers.append(PoolingLayer("pool3/3x3_s2", [bottom], "MAX", (3, 3),
                               (2, 2)))
    bottom = "pool3/3x3_s2"
    for key in ("4a", "4b", "4c", "4d", "4e"):
        ls, bottom = _inception(key, bottom, _INCEPTION[key])
        layers += ls
        if with_aux and key == "4a":
            layers += _aux_head(1, bottom, num_classes)
        if with_aux and key == "4d":
            layers += _aux_head(2, bottom, num_classes)
    layers.append(PoolingLayer("pool4/3x3_s2", [bottom], "MAX", (3, 3),
                               (2, 2)))
    bottom = "pool4/3x3_s2"
    for key in ("5a", "5b"):
        ls, bottom = _inception(key, bottom, _INCEPTION[key])
        layers += ls
    pool5 = PoolingLayer("pool5/7x7_s1", [bottom], "AVE", (7, 7), (1, 1))
    layers += [
        pool5,
        DropoutLayer("pool5/drop_7x7_s1", ["pool5/7x7_s1"],
                     tops=["pool5/7x7_s1"], ratio=0.4),
        _fc("loss3/classifier", "pool5/7x7_s1", num_classes,
            w_type="xavier"),
    ]
    loss = SoftmaxWithLoss("loss3/loss3", ["loss3/classifier", "label"])
    layers.append(loss)
    layers.append(AccuracyLayer("loss3/top-1", ["loss3/classifier", "label"]))
    return NetParam("GoogleNet", *layers)


def transformer_lm(vocab_size=512, seq_len=256, batch_size=8, d_model=256,
                   num_layers=4, num_heads=8, d_ff=None, max_positions=None,
                   flash=True, ring=False, with_data=True, moe_experts=0,
                   moe_aux_weight=0.01, moe_capacity_factor=None,
                   moe_stats=False):
    """Decoder-only causal transformer LM — the long-context model family.

    No CNN-era reference twin (SURVEY.md section 5: the reference has no
    attention); this is the workload the framework's sequence machinery
    exists for: the Attention layer dispatches to the pallas flash kernel
    per chip (``flash=True``) or ring attention across a "seq" mesh axis
    (``ring=True``), and pre-LN blocks keep bf16 activations stable.
    ``moe_experts > 0`` replaces every block's dense FFN with a
    Switch-MoE of that many experts (expert_parallel engages under an
    "expert" mesh axis), adding the load-balancing aux loss with weight
    ``moe_aux_weight``.

    Blobs: "data" (B, S) int32 token ids, "label" (B, S) int32 next-token
    ids. Loss is mean cross-entropy per token (SoftmaxWithLoss axis=2).

    Every "block{i}/" group is emitted by this one loop, so the blocks
    are structurally isomorphic by construction and chain through a
    single boundary blob — exactly what graph/compiler.py's
    scan-over-layers detector (_scan_runs) requires to collapse the
    stack into one scan run (SPARKNET_SCAN / ``--scan``), and what
    the per-block remat segments checkpoint (``--remat``). Renaming
    blocks away from the shared prefix, sharing params across blocks,
    or giving one block a different shape silently forfeits both.
    """
    d_ff = d_ff or 4 * d_model
    max_positions = max_positions or seq_len
    xavier = dict(type="xavier")
    layers = []
    if with_data:
        layers += [RDDLayer("data", [batch_size, seq_len]),
                   RDDLayer("label", [batch_size, seq_len])]
    layers += [
        EmbedLayer("tok_embed", ["data"], vocab_size, d_model,
                   weight_filler=xavier),
        PositionalEmbedLayer("pos_embed", ["tok_embed"], max_positions,
                             d_model, weight_filler=xavier,
                             tops=["embed"]),
    ]
    x = "embed"
    for i in range(num_layers):
        p = f"block{i}"
        layers += [
            LayerNormLayer(f"{p}/ln1", [x]),
            AttentionLayer(f"{p}/attn", [f"{p}/ln1"], num_heads,
                           causal=True, flash=flash, ring=ring),
            EltwiseLayer(f"{p}/res1", [x, f"{p}/attn"]),
            LayerNormLayer(f"{p}/ln2", [f"{p}/res1"]),
        ]
        if moe_experts:
            layers += [
                MoELayer(f"{p}/moe", [f"{p}/ln2"], moe_experts,
                         hidden_dim=d_ff, expert_parallel=True,
                         aux_loss_weight=moe_aux_weight,
                         capacity_factor=moe_capacity_factor,
                         stats=moe_stats),
                EltwiseLayer(f"{p}/res2", [f"{p}/res1", f"{p}/moe"]),
            ]
        else:
            layers += [
                InnerProductLayer(f"{p}/ffn1", [f"{p}/ln2"], d_ff,
                                  weight_filler=xavier, axis=2),
                ReLULayer(f"{p}/relu", [f"{p}/ffn1"], tops=[f"{p}/ffn1"]),
                InnerProductLayer(f"{p}/ffn2", [f"{p}/ffn1"], d_model,
                                  weight_filler=xavier, axis=2),
                EltwiseLayer(f"{p}/res2", [f"{p}/res1", f"{p}/ffn2"]),
            ]
        x = f"{p}/res2"
    layers += [
        LayerNormLayer("ln_f", [x]),
        InnerProductLayer("lm_head", ["ln_f"], vocab_size,
                          weight_filler=xavier, axis=2),
        SoftmaxWithLoss("loss", ["lm_head", "label"], axis=2),
    ]
    return NetParam("TransformerLM", *layers)


def transformer_lm_pieces(vocab_size=512, seq_len=256, batch_size=8,
                          d_model=256, num_heads=8, d_ff=None,
                          max_positions=None, flash=True):
    """transformer_lm split for pipeline parallelism: (prefix, block,
    suffix) NetParams.

    The trunk block is expressed ONCE; PipelineLMSolver stacks L inits of
    it on a leading dim and runs them as GPipe stages over a "pipe" mesh
    axis (parallel/pipeline_solver.py). Embedding (prefix) and head+loss
    (suffix) stay outside the pipeline, replicated — the stage-
    heterogeneous ends the pipeline docstring plans for.

    Layer names match transformer_lm's per-block names (ln1/attn/ffn1/
    ffn2...) so params map 1:1 onto "block{i}/<name>" for equivalence
    tests and checkpoint conversion.
    """
    d_ff = d_ff or 4 * d_model
    max_positions = max_positions or seq_len
    xavier = dict(type="xavier")
    prefix = NetParam(
        "TransformerLM_prefix",
        RDDLayer("data", [batch_size, seq_len]),
        EmbedLayer("tok_embed", ["data"], vocab_size, d_model,
                   weight_filler=xavier),
        PositionalEmbedLayer("pos_embed", ["tok_embed"], max_positions,
                             d_model, weight_filler=xavier, tops=["embed"]),
    )
    block = NetParam(
        "TransformerLM_block",
        RDDLayer("x", [batch_size, seq_len, d_model]),
        LayerNormLayer("ln1", ["x"]),
        AttentionLayer("attn", ["ln1"], num_heads, causal=True, flash=flash),
        EltwiseLayer("res1", ["x", "attn"]),
        LayerNormLayer("ln2", ["res1"]),
        InnerProductLayer("ffn1", ["ln2"], d_ff, weight_filler=xavier,
                          axis=2),
        ReLULayer("relu", ["ffn1"], tops=["ffn1"]),
        InnerProductLayer("ffn2", ["ffn1"], d_model, weight_filler=xavier,
                          axis=2),
        EltwiseLayer("res2", ["res1", "ffn2"]),
    )
    suffix = NetParam(
        "TransformerLM_suffix",
        RDDLayer("x", [batch_size, seq_len, d_model]),
        RDDLayer("label", [batch_size, seq_len]),
        LayerNormLayer("ln_f", ["x"]),
        InnerProductLayer("lm_head", ["ln_f"], vocab_size,
                          weight_filler=xavier, axis=2),
        SoftmaxWithLoss("loss", ["lm_head", "label"], axis=2),
    )
    return prefix, block, suffix
