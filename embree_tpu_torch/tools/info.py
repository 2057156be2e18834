"""embree_info analog: print build, runtime and device information.

Port of embree_tpu/tools/info.py (the reference's embree_info,
tutorials/embree_info): the version, the device configuration, the same
feature-support properties, and the facts of the card that replace the JAX
tool's TPU block: the card's name and power limit, the traversal kernel's
stack and launch shape (persistent warps, ``csrc/launch.cuh``), the L2
size, and whether the native builder builds here.

Usage: python -m embree_tpu_torch.tools.info [--config "verbose=1,..."]
       [--cpu]
"""
from __future__ import annotations

import argparse
import os
import re

PROPERTIES = ("version", "triangle_geometry_supported",
              "quad_geometry_supported", "curve_geometry_supported",
              "point_geometry_supported", "user_geometry_supported",
              "subdivision_geometry_supported", "ray_mask_supported",
              "filter_function_supported", "max_instance_level_count")


def launch_shape():
    """(threads a block, least resident blocks per SM, the same for B6's
    mixed-class variants), read from ``csrc/launch.cuh``."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc", "launch.cuh")
    text = open(path).read()

    def num(pattern):
        return int(re.search(pattern, text).group(1))
    return (num(r"constexpr int kBlock = (\d+);"),
            num(r"constexpr int kMinBlocks = (\d+);"),
            num(r"#define TRAV_MOTION_KINDS_MIN_BLOCKS (\d+)"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="device config string (rtcNewDevice analog)")
    ap.add_argument("--cpu", action="store_true",
                    help="the CPU instead of the card")
    args = ap.parse_args(argv)

    import torch

    import embree_tpu_torch as pt
    from embree_tpu_torch.accel import traverse as tr
    from embree_tpu_torch.native import native_available
    from embree_tpu_torch.rtcore import Device

    dev = Device(args.config, device="cpu" if args.cpu else None)
    print(f"embree_tpu_torch v{pt.__version__}")
    print(f"  platform            : {dev.device.type} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"  devices             : {dev.get_property('device_count')}")
    print(f"  config              : {dev.config}")
    block, min_blocks, b6_kinds = launch_shape()
    print("traversal kernel")
    if dev.device.type == "cuda":
        from embree_tpu_torch.perf.device import card_line
        props = torch.cuda.get_device_properties(dev.device)
        print(f"  card                : {card_line()}")
        print(f"  SMs                 : {props.multi_processor_count}")
        print(f"  L2                  : {props.L2_cache_size / 2**20:.0f} "
              f"MiB (tables beyond it stream from HBM)")
    else:
        print("  card                : none (CPU: the plain versions)")
    print(f"  stack capacity      : {tr.STACK} refs/ray")
    print(f"  launch shape        : persistent warps, {block} threads "
          f"({block // 32} warps) a block, at least {min_blocks} blocks "
          f"resident per SM ({b6_kinds} for B6's mixed classes), one grid "
          f"of resident blocks x SMs")
    print(f"  native C++ builder  : "
          f"{'available' if native_available() else 'unavailable'}")
    print("properties (rtcGetDeviceProperty analog)")
    for name in PROPERTIES:
        print(f"  {name:34s}: {dev.get_property(name)}")


if __name__ == "__main__":
    main()
