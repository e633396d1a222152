"""Dataset tools of the port: ``make_synth_cifar`` (the JAX package's
sparknet_tpu/tools.py make_synth_cifar). ``convert_cifar_data`` writes
LMDB and comes with the port's DB writers."""

import os


def make_synth_cifar(out_dir, n_train=50000, n_test=10000, seed=0,
                     noise=28.0, label_noise=0.0, log=print):
    """Write a CIFAR-10-format synthetic dataset (5 train .bin batches +
    test_batch.bin) of shape/texture-class images (see
    data/synthetic.shape_texture_images).  Stands in for the real bits the
    reference downloads in data/cifar10/get_cifar10.sh when the environment
    has no network egress; the files feed CifarDataset and the ``cifar``
    verb unchanged, and equal the JAX package's byte for byte."""
    from .data.synthetic import shape_texture_images
    from .data.cifar import write_batch_file
    os.makedirs(out_dir, exist_ok=True)
    per = n_train // 5
    for b in range(5):
        imgs, labels = shape_texture_images(per, seed=seed + b, noise=noise,
                                            label_noise=label_noise)
        write_batch_file(os.path.join(out_dir, f"data_batch_{b + 1}.bin"),
                         imgs, labels)
        log(f"data_batch_{b + 1}.bin: {per} records")
    imgs, labels = shape_texture_images(n_test, seed=seed + 1000, noise=noise,
                                        label_noise=label_noise)
    write_batch_file(os.path.join(out_dir, "test_batch.bin"), imgs, labels)
    log(f"test_batch.bin: {n_test} records")
