"""``Renderer.bvh_build_s``: host seconds of the wide BVH's build; nothing
on a brute-force scene, which builds none."""


def read(rec):
    return rec.bvh_build_s
