"""A module's code without its docstrings, for the tests that hold a
port module to be the reference's copy."""
import ast


def code_only(path, rename=False):
    """The module's AST with every docstring dropped (``repro_torch`` read
    as ``repro`` when ``rename``)."""
    text = path.read_text()
    if rename:
        text = text.replace("repro_torch", "repro")
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)
