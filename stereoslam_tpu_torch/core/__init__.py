"""The SLAM pipeline: state, frontend, backend, maintenance, facade."""
