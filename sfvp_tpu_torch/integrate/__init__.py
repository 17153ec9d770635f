from .wavefront import RenderState, init_state, make_render_step  # noqa: F401
